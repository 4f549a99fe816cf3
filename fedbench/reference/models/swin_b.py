"""Swin-B (Liu et al. 2021, arXiv:2103.14030, §3.1–3.2, Table 1) in plain
float32, on the program's ``state_dict`` names, written apart from the
program: a 4×4 patch embedding to C = 128 and a LayerNorm; stages of 2, 2,
18 and 2 pre-norm blocks, 128, 256, 512 and 1024 wide with 4, 8, 16 and 32
heads of 32; windowed multi-head attention over 7×7 windows with a learned
relative-position bias table of (2M − 1)² × heads, the window shifted by 3
on every second block under the mask that keeps the rolled-in regions apart;
an MLP of ratio 4 with exact GELU; patch merging (2×2 neighbours
concatenated, LayerNorm(4C), Linear(4C → 2C) without bias) after stages
1–3; a final LayerNorm, average pooling and a linear head. LayerNorm eps
1e-5. The attention is written out: q·kᵀ/√d, plus the bias and mask, a
softmax, times v. TF32 is switched off around the forward, so float32
computes in float32.

Departures from the paper, each torchvision's ``swin_b`` (the zoo the FedMLP
reference builds from): a map that is not a multiple of the window is
zero-padded to one after ``norm1`` and the padded tokens are not masked, and
where the window covers the padded map the shift is 0 (at 224 px nothing is
padded); the shift mask adds −100, not −∞; an odd map is padded by one
before patch merging. Stochastic depth rises linearly from 0 over the 24
blocks to 0.5 (the paper's Swin-B setting) and drops each residual branch on
its own per-sample draw.

Draws, in the order the program states for a train-mode forward with a
generator: each block whose rate is above 0 takes one uniform [2, B] just
before it runs (row 0 for the attention branch, row 1 for the MLP's); a
sample's branch is kept when ⌊1 − rate + u⌋ = 1 and then scaled by 1/(1 −
rate). No draw in eval mode or without a generator.

``quant`` (the control) rounds every operand and output of the backbone with
``layers.q`` to fp8 e4m3; the head stays in float32, as the program's does.

The architecture's numbers (width, depths, heads, window, stochastic-depth
rate) are arguments of ``init_weights`` and ``forward``, Swin-B's by default,
so that a small Swin can be held against the program on the CPU.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from fedbench.reference.layers import linear, q

EMBED, DEPTHS, HEADS, WINDOW, DROP_PATH = 128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.5
PATCH, MLP_RATIO, LN_EPS, MASKED = 4, 4, 1e-5, -100.0
FEATURE_DIM = EMBED * 2 ** (len(DEPTHS) - 1)
INIT_STD = 0.02


def arch(embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS, window=WINDOW,
         drop_path=DROP_PATH) -> dict:
    return dict(embed_dim=embed_dim, depths=tuple(depths), num_heads=tuple(num_heads),
                window=window, drop_path=drop_path)


def blocks(a: dict):
    """[(stage, name, width, heads, shift, stochastic-depth rate)] of every
    block, in order."""
    out, total, gi = [], sum(a["depths"]), 0
    for i, (depth, heads) in enumerate(zip(a["depths"], a["num_heads"])):
        for j in range(depth):
            out.append((i, f"stage{i}_{j}", a["embed_dim"] * 2 ** i, heads,
                        a["window"] // 2 if j % 2 else 0,
                        a["drop_path"] * gi / max(total - 1, 1)))
            gi += 1
    return out


def init_weights(n_classes: int, generator: torch.Generator, device, **kw) -> dict:
    """The published initialization: Linear weights and bias tables normal
    with σ 0.02 (torchvision's ``trunc_normal_`` cuts at ±2, a hundred σ),
    biases 0, LayerNorm 1 and 0, the patch embedding's weight and bias
    uniform in ±1/√fan_in (PyTorch's Conv2d default)."""
    a = arch(**kw)
    C, M = a["embed_dim"], a["window"]
    normal = {}
    w = {"patch_norm.weight": torch.ones(C, device=device),
         "patch_norm.bias": torch.zeros(C, device=device)}

    def ln(name, ch):
        w[name + ".weight"] = torch.ones(ch, device=device)
        w[name + ".bias"] = torch.zeros(ch, device=device)

    def lin(name, cin, cout, bias=True):
        normal[name + ".weight"] = (cout, cin)
        if bias:
            w[name + ".bias"] = torch.zeros(cout, device=device)

    for i, name, dim, heads, _shift, _rate in blocks(a):
        ln(f"{name}.norm1", dim)
        lin(f"{name}.attn.qkv", dim, 3 * dim)
        lin(f"{name}.attn.proj", dim, dim)
        normal[f"{name}.attn.relative_position_bias_table"] = ((2 * M - 1) ** 2, heads)
        ln(f"{name}.norm2", dim)
        lin(f"{name}.mlp.fc1", dim, MLP_RATIO * dim)
        lin(f"{name}.mlp.fc2", MLP_RATIO * dim, dim)
    for i in range(len(a["depths"]) - 1):
        dim = C * 2 ** i
        ln(f"merge{i}.norm", 4 * dim)
        lin(f"merge{i}.reduction", 4 * dim, 2 * dim, bias=False)
    features = C * 2 ** (len(a["depths"]) - 1)
    ln("norm", features)
    lin("head.fc", features, n_classes)
    bound = (3 * PATCH * PATCH) ** -0.5
    u = torch.rand(C * 3 * PATCH * PATCH + C, generator=generator, device=device)
    u = u * 2 * bound - bound
    w["patch_embed.weight"] = u[:-C].reshape(C, 3, PATCH, PATCH)
    w["patch_embed.bias"] = u[-C:]
    total = sum(torch.Size(s).numel() for s in normal.values())
    flat = torch.randn(total, generator=generator, device=device) * INIT_STD
    at = 0
    for name, shape in normal.items():
        n = torch.Size(shape).numel()
        w[name] = flat[at:at + n].reshape(shape)
        at += n
    return w


@contextlib.contextmanager
def _float32_matmuls():
    """TF32 off for the enclosed work (cuBLAS and cuDNN), restored after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def forward(w: dict, x, train: bool, generator=None, upd=None, quant: bool = False, **kw):
    """(feature [B, C·2³], logits [B, n]). ``upd`` is unused (no running
    statistics); stochastic depth only in training with a generator."""
    a = arch(**kw)
    M = a["window"]
    stochastic = train and generator is not None
    with _float32_matmuls():
        def lin(h, name, bias=True):
            return q(F.linear(q(h, quant), q(w[name + ".weight"], quant),
                              w[name + ".bias"] if bias else None), quant)

        def norm(h, name):
            return q(F.layer_norm(h, h.shape[-1:], w[name + ".weight"], w[name + ".bias"],
                                  LN_EPS), quant)

        h = F.conv2d(q(x, quant), q(w["patch_embed.weight"], quant), w["patch_embed.bias"],
                     stride=PATCH)
        h = norm(q(h, quant).permute(0, 2, 3, 1), "patch_norm")  # [B, H, W, C]
        stage = 0
        for i, name, dim, heads, shift, rate in blocks(a):
            if i != stage:
                h = merge(h, f"merge{stage}", lin, norm)
                stage = i
            u = None
            if stochastic and rate > 0:
                u = torch.rand((2, h.shape[0]), generator=generator, device=h.device)
            y = window_attention(norm(h, f"{name}.norm1"), w, f"{name}.attn", heads, M, shift,
                                 lin, quant)
            h = q(h + drop(y, rate, u, 0, quant), quant)
            y = lin(q(F.gelu(lin(norm(h, f"{name}.norm2"), f"{name}.mlp.fc1")), quant),
                    f"{name}.mlp.fc2")
            h = q(h + drop(y, rate, u, 1, quant), quant)
        feature = norm(h, "norm").mean((1, 2))
    return feature, linear(feature, w, "head.fc")


def drop(y, rate: float, u, row: int, quant: bool):
    """Per-sample stochastic depth of a residual branch [B, H, W, C]."""
    if u is None:
        return y
    keep = 1.0 - rate
    return q(y / keep * torch.floor(keep + u[row]).view(-1, 1, 1, 1), quant)


def merge(h, name: str, lin, norm):
    """Patch merging: [B, H, W, C] → [B, ⌈H/2⌉, ⌈W/2⌉, 2C]."""
    H, W = h.shape[1:3]
    h = F.pad(h, (0, 0, 0, W % 2, 0, H % 2))
    h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2], h[:, 0::2, 1::2], h[:, 1::2, 1::2]], -1)
    return lin(norm(h, name + ".norm"), name + ".reduction", bias=False)


def region_mask(hp: int, wp: int, M: int, sh: int, sw: int, device) -> torch.Tensor:
    """[windows, M², M²]: 0 between tokens of one region of the rolled map,
    −100 across regions."""
    def bounds(n, s):  # the three strips of a rolled axis, or the whole axis
        return [(0, n - M), (n - M, n - s), (n - s, n)] if s else [(0, n)]

    label = torch.zeros((hp, wp), device=device)
    for r, (h0, h1) in enumerate(bounds(hp, sh)):
        for c, (w0, w1) in enumerate(bounds(wp, sw)):
            label[h0:h1, w0:w1] = r * 3 + c
    label = label.view(hp // M, M, wp // M, M).permute(0, 2, 1, 3).reshape(-1, M * M)
    same = label[:, :, None] == label[:, None, :]
    return torch.where(same, 0.0, MASKED)


def bias_of(table, M: int, heads: int) -> torch.Tensor:
    """[heads, M², M²]: token i's bias towards token j from the table, by
    their offset (dy, dx) in [−(M − 1), M − 1]²."""
    ys, xs = torch.meshgrid(torch.arange(M), torch.arange(M), indexing="ij")
    ys, xs = ys.flatten(), xs.flatten()
    row = (ys[:, None] - ys[None, :] + M - 1) * (2 * M - 1) + (xs[:, None] - xs[None, :] + M - 1)
    return table[row.to(table.device)].permute(2, 0, 1)


def window_attention(h, w: dict, name: str, heads: int, M: int, shift: int, lin, quant):
    """(Shifted-)window attention on [B, H, W, C], written out."""
    B, H, W, C = h.shape
    hp, wp = -(-H // M) * M, -(-W // M) * M
    sh, sw = (shift if M < hp else 0), (shift if M < wp else 0)
    h = F.pad(h, (0, 0, 0, wp - W, 0, hp - H))
    if sh or sw:
        h = torch.roll(h, (-sh, -sw), (1, 2))
    nh, nw = hp // M, wp // M
    t = h.reshape(B, nh, M, nw, M, C).permute(0, 1, 3, 2, 4, 5).reshape(B, nh * nw, M * M, C)
    d = C // heads
    qkv = lin(t, name + ".qkv").reshape(B, nh * nw, M * M, 3, heads, d)
    qq, kk, vv = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))  # [B, nW, heads, N, d]
    score = q(qq @ kk.transpose(-1, -2) * d ** -0.5, quant)
    bias = bias_of(w[name + ".relative_position_bias_table"], M, heads)
    score = score + q(bias, quant)
    if sh or sw:
        score = score + region_mask(hp, wp, M, sh, sw, h.device)[None, :, None]
    p = q(torch.softmax(q(score, quant), -1), quant)
    o = q(p @ vv, quant).transpose(2, 3).reshape(B, nh * nw, M * M, C)
    o = lin(o, name + ".proj")
    o = o.reshape(B, nh, nw, M, M, C).permute(0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)
    if sh or sw:
        o = torch.roll(o, (sh, sw), (1, 2))
    return o[:, :H, :W]
