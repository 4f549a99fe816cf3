"""Swin Transformer (Liu et al. 2021, arXiv:2103.14030, §3.1–3.2 and Table
1), Swin-B by default, written as torchvision's ``swin_b`` writes it. The
port's own model: the JAX package has no counterpart.

A 4×4 patch embedding to ``embed_dim`` channels and a LayerNorm; four stages
of pre-norm blocks (windowed multi-head attention with a learned
relative-position bias, then an MLP of ratio 4 with GELU), the shifted
window (a cyclic roll by half the window, with the mask that keeps the
rolled-in tokens apart) on every second block; patch merging (the 2×2
neighbours concatenated, LayerNorm, a bias-free linear to twice the width)
after each stage but the last; a final LayerNorm, average pooling and the
task head. Activations are channels-last [B, H, W, C] inside the backbone.

As in torchvision, a map that is not a multiple of the window is
zero-padded to one after ``norm1`` and the padded tokens are not masked;
where the window covers the padded map, the shift is 0. At 224 px nothing is
padded and the model is the paper's.

Each block's attention is ONE fused call,
``torch.nn.functional.scaled_dot_product_attention``, with the bias (plus
the shift mask where there is one) as ``attn_mask``. On the card it runs
PyTorch's memory-efficient (CUTLASS) backend, pinned, which returns the
bias's gradient; elsewhere PyTorch's choice. The relative-position index and
the shift masks are non-persistent buffers, made for the ``image_size`` the
model is built for (a forward at another size raises), so they never enter
a ``state_dict``.

Stochastic depth rises linearly over the blocks from 0 to ``drop_path``
(0.5, Swin-B's). As torchvision's per-sample ("row") stochastic depth drops
each residual branch on its own draw, a block with a rate above 0 takes
one uniform [2, B] from the generator just before it runs (row 0 the
attention branch, row 1 the MLP's); a forward in eval mode or without a
generator draws nothing.

Tracing: the attention counts its calls and rows (batch × windows × heads)
in the program's counters (``utils/profiling.py``), split by whether
autograd records the call. No span is opened inside the model: the per-client
loop replays the step from a CUDA graph, which runs no Python, so a span here
would time the capture alone. The loop re-adds, on every replay, the counts
its capture made (``parallel/step_graph.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from fedmlp_tpu_torch.models.heads import make_head
from fedmlp_tpu_torch.models.layers import drop_connect
from fedmlp_tpu_torch.utils import profiling as trace

# Swin-B (Table 1): C, blocks a stage, heads a stage, window M, stochastic depth
SWIN_B = dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=7,
              drop_path=0.5)
PATCH, MLP_RATIO, LN_EPS = 4, 4, 1e-5
MASK_VALUE = -100.0  # torchvision's additive mask between shifted-in regions
INIT_STD = 0.02


def stage_sides(image_size: int, n_stages: int) -> list:
    """The feature map's side at each stage: the patch embedding's floor, then
    each patch merging's ceiling (an odd map is padded by one)."""
    sides = [image_size // PATCH]
    for _ in range(n_stages - 1):
        sides.append(-(-sides[-1] // 2))
    return sides


def window_plan(h: int, w: int, window: int, shift: int) -> tuple:
    """(padded h, padded w, shift along h, shift along w) of a block on an
    h×w map: padded to multiples of the window, no shift along an axis the
    window covers."""
    hp, wp = h + (-h) % window, w + (-w) % window
    return hp, wp, shift if window < hp else 0, shift if window < wp else 0


def relative_position_index(window: int) -> torch.Tensor:
    """[M²·M²] rows of the (2M − 1)² bias table: token i's offset to token j."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).flatten()


def shift_mask(hp: int, wp: int, window: int, sh: int, sw: int) -> torch.Tensor:
    """[windows, M², M²] additive mask of a shifted block on a padded hp×wp
    map: 0 between tokens of one region of the rolled map, −100 across."""
    def slices(s):
        return ((0, -window), (-window, -s), (-s, None)) if s else ((0, None),)

    region = torch.zeros((hp, wp))
    count = 0
    for h in slices(sh):
        for w in slices(sw):
            region[h[0]:h[1], w[0]:w[1]] = count
            count += 1
    region = region.view(hp // window, window, wp // window, window).permute(0, 2, 1, 3)
    region = region.reshape(-1, window * window)
    diff = region[:, None, :] - region[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] (H, W multiples of the window) → [B·windows, M², C]."""
    B, H, W, C = x.shape
    x = x.view(B, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, C)


def window_reverse(x: torch.Tensor, window: int, B: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    x = x.view(B, H // window, W // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def attention(q, k, v, attn_mask) -> torch.Tensor:
    """softmax(q·kᵀ/√d + attn_mask)·v in one fused call: on the card the
    memory-efficient backend (it returns ``attn_mask``'s gradient)."""
    if q.is_cuda:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)


class WindowAttention(nn.Module):
    """(Shifted-)window multi-head self-attention on [B, H, W, C] with a
    learned relative-position bias; ``side`` is the map side the shift mask
    buffer is made for."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, side: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.plan = window_plan(side, side, window, shift)
        hp, wp, sh, sw = self.plan
        self.register_buffer("mask", shift_mask(hp, wp, window, sh, sw) if sh or sw else None,
                             persistent=False)

    def _bias(self) -> torch.Tensor:
        """The additive ``attn_mask`` [windows or 1, heads, M², M²]: the bias
        gathered from its table, plus the shift mask where the block shifts."""
        n = self.window * self.window
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.view(n, n, self.heads).permute(2, 0, 1).contiguous().unsqueeze(0)
        return bias if self.mask is None else self.mask.unsqueeze(1) + bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        M, heads = self.window, self.heads
        if window_plan(H, W, M, self.shift) != self.plan:
            raise ValueError(f"a {H}x{W} map in a block built for another image_size: "
                             "build the model at the size it runs at")
        hp, wp, sh, sw = self.plan
        x = F.pad(x, (0, 0, 0, wp - W, 0, hp - H))
        if sh or sw:
            x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
        x = window_partition(x, M)  # [B·nW, N, C]
        bw, n = x.shape[:2]
        qkv = self.qkv(x).reshape(bw, n, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B·nW, heads, N, d]
        bias = self._bias().to(q.dtype)
        if bias.shape[0] > 1:  # a mask a window: row b·nW + w takes window w's
            bias = bias.expand(B, -1, -1, -1, -1).reshape(bw, heads, n, n)
        recorded = q.requires_grad
        trace.count(trace.ATTN_CALLS_GRAD if recorded else trace.ATTN_CALLS_NOGRAD)
        trace.count(trace.ATTN_ROWS_GRAD if recorded else trace.ATTN_ROWS_NOGRAD, bw * heads)
        x = attention(q, k, v, bias).transpose(1, 2).reshape(bw, n, C)
        x = window_reverse(self.proj(x), M, B, hp, wp)
        if sh or sw:
            x = torch.roll(x, shifts=(sh, sw), dims=(1, 2))
        return x[:, :H, :W, :]


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)), then + mlp(norm2(x)),
    each branch under per-sample stochastic depth at ``drop_rate``."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, side: int,
                 drop_rate: float):
        super().__init__()
        self.drop_rate = drop_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window, shift, side)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor, u=None) -> torch.Tensor:
        """``u``: the block's stochastic-depth uniforms [2, B], or None."""
        h = self.attn(self.norm1(x))
        x = x + (h if u is None else drop_connect(h, self.drop_rate, u[0].view(-1, 1, 1, 1)))
        h = self.mlp(self.norm2(x))
        return x + (h if u is None else drop_connect(h, self.drop_rate, u[1].view(-1, 1, 1, 1)))


class PatchMerging(nn.Module):
    """[B, H, W, C] → [B, ⌈H/2⌉, ⌈W/2⌉, 2C]: the 2×2 neighbours concatenated
    (an odd map padded by one), LayerNorm(4C), a bias-free Linear(4C → 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """``forward(x [B, 3, S, S], generator=None) -> (feature float32 [B,
    C·2³], logits)``. Blocks are ``stage{i}_{j}``, patch merging
    ``merge{i}``; ``image_size`` sets the map sides the shift masks are made
    for."""

    def __init__(self, num_classes: int, embed_dim: int = SWIN_B["embed_dim"],
                 depths=SWIN_B["depths"], num_heads=SWIN_B["num_heads"],
                 window: int = SWIN_B["window"], drop_path: float = SWIN_B["drop_path"],
                 image_size: int = 224, normed_head: bool = False):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, embed_dim, PATCH, PATCH)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        sides = stage_sides(image_size, len(depths))
        total = sum(depths)
        self.stages = []  # [(block names, merge name or None)]
        gi = 0
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            names = []
            for j in range(depth):
                name = f"stage{i}_{j}"
                rate = drop_path * gi / max(total - 1, 1)
                self.add_module(name, SwinBlock(dim, heads, window, 0 if j % 2 == 0
                                                else window // 2, sides[i], rate))
                names.append(name)
                gi += 1
            merge = None
            if i < len(depths) - 1:
                merge = f"merge{i}"
                self.add_module(merge, PatchMerging(dim))
            self.stages.append((names, merge))
        self.feature_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.feature_dim, eps=LN_EPS)
        self.head = make_head(self.feature_dim, num_classes, normed_head)

    def forward(self, x: torch.Tensor, generator=None):
        stochastic = self.training and generator is not None
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        for names, merge in self.stages:
            for name in names:
                blk = getattr(self, name)
                u = (torch.rand((2, x.shape[0]), generator=generator, device=x.device)
                     if stochastic and blk.drop_rate > 0 else None)
                x = blk(x, u)
            if merge is not None:
                x = getattr(self, merge)(x)
        feature = self.norm(x).mean((1, 2)).float()
        return feature, self.head(feature)


def swin_b(num_classes: int, **kw) -> SwinTransformer:
    return SwinTransformer(num_classes, **kw)


@torch.no_grad()
def init_module(m: nn.Module, generator: torch.Generator) -> bool:
    """Swin's published initialization of ``m`` (torchvision's ``swin_b``
    and the paper's code), drawn from ``generator`` on the CPU: Linear
    weights and the bias tables truncated normal with σ 0.02 (cut at ±2, as
    ``nn.init.trunc_normal_``'s default), Linear biases 0, LayerNorm 1 and 0,
    the patch embedding PyTorch's default Conv2d draw. False for a module
    it does not initialize (the cosine head, a container)."""
    def normal_(t):
        w = torch.empty(t.shape)
        nn.init.trunc_normal_(w, 0.0, INIT_STD, -2.0, 2.0, generator=generator)
        t.copy_(w)

    if isinstance(m, nn.Linear):
        normal_(m.weight)
        if m.bias is not None:
            m.bias.zero_()
    elif isinstance(m, nn.LayerNorm):
        m.weight.fill_(1.0)
        m.bias.zero_()
    elif isinstance(m, WindowAttention):
        normal_(m.relative_position_bias_table)
    elif isinstance(m, nn.Conv2d):
        bound = 1.0 / math.sqrt(m.weight[0].numel())  # kaiming_uniform_(a=√5)
        m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * bound - bound)
        m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 2 * bound - bound)
    else:
        return False
    return True

