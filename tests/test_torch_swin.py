"""Swin-B (``models/swin.py``), the port's own model, on the CPU at a small
Swin made through the constructor: width 16, depths (2, 2, 2, 2), heads (1, 1,
2, 2), window 4, 64 px. Stage 1 (16×16 tokens) shifts under a mask, stage 2
(8×8) too, stage 3 (4×4) is one window that covers the map (no shift), stage
4 (2×2) is padded to a window; patch merging joins them.

* The program against the plain reference (``fedbench/reference/models/
  swin_b.py``, float32, attention written out) on the same weights and
  generator: logits, features and every parameter's gradient, in eval mode
  and in train mode with stochastic depth.
* The fused attention call against the written-out softmax chain, its
  gradients with the bias's among them.
* ``state_dict`` holds no index or mask buffer and round-trips bit for bit
  through the JAX layout of ``weights.py``; ``init_model`` draws the
  published distributions.
* The engines: the stacked engine refuses ``swin_b`` by name, the lockstep
  engine runs it as the per-client loop does.
* The attention's counters, and the static step's re-add of what its
  capture counted (a CUDA graph faked on the CPU).
"""

import contextlib

import numpy as np
import pytest
import torch

from fedbench.reference.models import swin_b as R
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.models import swin
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.parallel import step_graph as G
from fedmlp_tpu_torch.train import Trainer, UnportedConfigError, check_ported
from fedmlp_tpu_torch.utils import profiling as P
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2), window=4)
IMG, C = 64, 4
# float32 on both sides, the sums in another order (a fused attention against
# a written-out one, a merged qkv projection, autograd's own reductions): a few
# ulps of the largest magnitude, far under any bf16 or fp8 rounding (2⁻⁸)
TOL = 1e-4


def _small(**kw):
    return build_model("swin_b", C, image_size=IMG, **{**SMALL, **kw})


def _close(a, b, what):
    scale = b.abs().max().item() or 1.0
    gap = (a - b).abs().max().item()
    assert gap <= TOL * scale, (what, gap, scale)


def test_the_small_swin_covers_every_path():
    m = _small()
    plans = [getattr(m, f"stage{i}_{j}").attn.plan for i in range(4) for j in range(2)]
    assert plans[1] == (16, 16, 2, 2) and plans[3] == (8, 8, 2, 2)  # shifted, masked
    assert plans[5] == (4, 4, 0, 0)  # the window covers the map: no shift
    assert plans[7] == (4, 4, 0, 0) and swin.stage_sides(IMG, 4)[3] == 2  # padded
    assert [getattr(m, f"merge{i}").reduction.out_features for i in range(3)] == [32, 64, 128]


def test_a_forward_at_another_size_raises():
    m = _small().eval()
    with torch.no_grad():
        assert m(torch.zeros(1, 3, IMG, IMG))[1].shape == (1, C)
        with pytest.raises(ValueError, match="image_size"):
            m(torch.zeros(1, 3, 2 * IMG, 2 * IMG))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_program_equals_the_reference(train):
    w = R.init_weights(C, torch.Generator().manual_seed(3), "cpu", **SMALL)
    model = _small()
    model.load_state_dict(w)  # strict: the same names and shapes
    model.train(train)
    ref_w = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    x = torch.randn(4, 3, IMG, IMG, generator=torch.Generator().manual_seed(1))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    f1, l1 = model(x, generator=g1)
    f2, l2 = R.forward(ref_w, x, train, g2, **SMALL)
    assert torch.equal(g1.get_state(), g2.get_state())  # the same draws taken
    drew = not torch.equal(g1.get_state(), torch.Generator().manual_seed(5).get_state())
    assert drew == train
    _close(f1, f2, "feature")
    _close(l1, l2, "logits")
    (l1.square().sum() + f1.sum()).backward()
    (l2.square().sum() + f2.sum()).backward()
    for n, p in model.named_parameters():
        _close(p.grad, ref_w[n].grad, n)
    if train:  # stochastic depth dropped a branch: eval mode gives other logits
        with torch.no_grad():
            assert (model.eval()(x)[1] - l1).abs().max() > 1e-3


def test_fused_attention_equals_the_written_out_softmax():
    g = torch.Generator().manual_seed(2)
    # 2 images of 4 windows of 16 tokens, 2 heads of 8
    q, k, v = (torch.randn(8, 2, 16, 8, generator=g, requires_grad=True) for _ in range(3))
    table = torch.randn(49, 2, generator=g, requires_grad=True)
    mask = swin.shift_mask(8, 8, 4, 2, 2)  # [4, 16, 16]
    bias = table[swin.relative_position_index(4)].view(16, 16, 2).permute(2, 0, 1)
    full = (mask[:, None] + bias[None]).repeat(2, 1, 1, 1)
    fused = swin.attention(q, k, v, full)
    grads = torch.autograd.grad(fused.square().sum(), (q, k, v, table), retain_graph=True)
    p = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5 + full, -1)
    plain = p @ v
    want = torch.autograd.grad(plain.square().sum(), (q, k, v, table))
    _close(fused, plain, "output")
    for name, a, b in zip("qkv", grads, want):
        _close(a, b, name)
    _close(grads[3], want[3], "bias table")
    assert (mask == swin.MASK_VALUE).any() and (mask == 0).any()


def test_state_dict_holds_no_buffers_and_round_trips_the_jax_layout():
    m = _small()
    init_model(m, 0)
    sd = m.state_dict()
    buffers = {n for n, _ in m.named_buffers()}
    assert buffers and not buffers & set(sd)  # the index and the masks
    assert set(sd) == {n for n, _ in m.named_parameters()}
    back = from_jax_variables(to_jax_variables(sd))
    assert set(back) == set(sd)
    for n, t in sd.items():
        assert torch.equal(back[n], t), n
    tree = to_jax_variables(sd)["params"]
    assert tree["stage0_1"]["attn"]["relative_position_bias_table"].shape == (49, 1)


def test_init_model_draws_the_published_distributions():
    m = init_model(build_model("swin_b", 8, image_size=IMG, embed_dim=32, depths=(2, 2, 2, 2),
                               num_heads=(1, 2, 4, 8), window=7), 11)
    linear = torch.cat([mod.weight.flatten() for mod in m.modules()
                        if isinstance(mod, torch.nn.Linear)])
    tables = torch.cat([mod.relative_position_bias_table.flatten() for mod in m.modules()
                        if isinstance(mod, swin.WindowAttention)])
    for t in (linear, tables):
        assert abs(t.std().item() - 0.02) < 0.02 * 0.05 and abs(t.mean().item()) < 1e-3
        assert t.abs().max().item() < 0.02 * 6
    for mod in m.modules():
        if isinstance(mod, torch.nn.Linear) and mod.bias is not None:
            assert not mod.bias.any()
        if isinstance(mod, torch.nn.LayerNorm):
            assert (mod.weight == 1).all() and not mod.bias.any()
    bound = 48 ** -0.5  # PyTorch's Conv2d default, fan_in 3 · 4 · 4
    conv = m.patch_embed.weight
    assert conv.abs().max().item() <= bound and conv.std().item() > 0.9 * bound / 3 ** 0.5
    assert m.patch_embed.bias.abs().max().item() <= bound
    cosine = init_model(build_model("swin_b", 8, image_size=IMG, normed_head=True, **SMALL), 1)
    w = cosine.head.weight
    assert 0.0 <= w.min().item() and w.max().item() <= 2.0  # the cosine head's own draw


def _cfg(**kw):
    data = DataConfig(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=48,
                      synthetic_test_size=8, augment_backend="normonly")
    return Config(**{**dict(algorithm="fedmlp", model="swin_b", batch_size=8, base_lr=1e-3,
                            n_clients=3, local_ep=1, rounds_warmup=4, eval_every=10_000, seed=7,
                            p_pos=0.0, compute_dtype="float32", output_dir=""), **kw},
                  fedmlp=FedMLPConfig(rounds_stage1=50), data=data)


def test_the_stacked_engine_refuses_swin_by_name():
    with pytest.raises(UnportedConfigError, match="client_stacking='on'.*'swin_b'"):
        check_ported(_cfg(client_stacking="on"))


def test_the_lockstep_engine_runs_swin_as_the_per_client_loop(monkeypatch):
    """Two FedMLP stage-1 rounds of 3 clients on a small Swin without
    stochastic depth ('normonly' views: no random stream has to match, as in
    tests/test_torch_lockstep.py, whose tolerances these are)."""
    monkeypatch.setattr(Trainer, "_build_model", lambda self: _small(drop_path=0.0))
    runs = []
    for engine in ("auto", "on"):
        t = Trainer(_cfg(batched_global=engine), device="cpu")
        runs.append((t.engine, [t.run_round(r).client_losses for r in range(2)],
                     t.global_vars))
    (e_loop, l_loop, v_loop), (e_lock, l_lock, v_lock) = runs
    assert (e_loop, e_lock) == ("mapped", "lockstep")
    np.testing.assert_allclose(l_lock, l_loop, rtol=1e-4, atol=1e-5)
    for n in v_loop:
        np.testing.assert_allclose(v_lock[n].numpy(), v_loop[n].numpy(), rtol=2e-3, atol=5e-4,
                                   err_msg=n)


def test_attention_counts_its_calls_and_rows():
    m = _small()
    init_model(m, 0)
    x = torch.randn(2, 3, IMG, IMG)
    # rows a forward: B × windows × heads, over the 8 blocks
    rows = 2 * (2 * 16 * 1 + 2 * 4 * 1 + 2 * 1 * 2 + 2 * 1 * 2)
    P.reset()
    with P.round_record(0):
        m.train()(x)
        with torch.no_grad():
            m.eval()(x)
    c = P.HISTORY[-1]["counters"]
    assert (c[P.ATTN_CALLS_GRAD], c[P.ATTN_ROWS_GRAD]) == (8, rows)
    assert (c[P.ATTN_CALLS_NOGRAD], c[P.ATTN_ROWS_NOGRAD]) == (8, rows)


class _FakeGraph:
    """A CUDA graph on the CPU: the capture runs the body eagerly (and
    counts), a replay runs nothing."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_a_replay_adds_what_its_capture_counted(monkeypatch):
    """With a faked capture, a round of the static step counts each
    replayed step's attention calls and rows as the eager loop counts them:
    the capture's own counts are undone, each replay adds them again."""
    data, plan = _federation()
    counts = []
    for loss_fn, capture in ((tfedmlp.loss_fn, True), (_unmarked(tfedmlp.loss_fn), False)):
        with monkeypatch.context() as mp:
            if capture:
                mp.setattr(G, "can_capture", lambda device: True)
                mp.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
                mp.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
            model, glob = _small(), _small()
            gv = {n: v.clone() for n, v in init_model(_small(), 3).state_dict().items()}
            fn = rt.make_local_round(model, loss_fn, lr=1e-3, batch_size=4, mean=(0.5,) * 3,
                                     std=(0.25,) * 3, view_mode="dual", needs_global=True,
                                     augment_backend="normonly", global_model=glob)
            P.reset()
            with P.round_record(0):
                fn(gv, data, plan, {}, torch.Generator().manual_seed(1))
            counts.append(P.HISTORY[-1]["counters"])
    graphed, eager = counts
    live = int(plan["pos_valid"].any(2).sum())
    assert graphed[P.GRAPH_STEPS] == live - G.WARMUP_STEPS and graphed[P.GRAPH_CAPTURES] == 1
    for name in (P.ATTN_CALLS_GRAD, P.ATTN_ROWS_GRAD, P.ATTN_CALLS_NOGRAD, P.ATTN_ROWS_NOGRAD):
        assert graphed[name] == eager[name] > 0, name
    assert eager[P.ATTN_CALLS_GRAD] == live * 2 * 8  # two trained views, 8 blocks


def _unmarked(loss_fn):
    def loss(*a, **kw):
        return loss_fn(*a, **kw)
    return loss


def _federation():
    rng = np.random.RandomState(0)
    sizes = (12, 8)
    n = sum(sizes)
    images = rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    users = {0: list(range(12)), 1: list(range(12, n))}
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    fd = rt.build_federated_data(images, targets, users, np.zeros_like(targets, bool),
                                 [[0], [1]], device="cpu")
    pos, pos_valid, _ = rt.make_batch_plan(np.random.RandomState(0), fd.valid.numpy(), 4, 1)
    active = fd.active.float()
    data = {"images": fd.images, "idx": fd.idx,
            "ctx": {"active": active, "negative": 1.0 - active, "loss_w": fd.loss_w}}
    return data, {"pos": pos, "pos_valid": pos_valid, "sample": {"labels": fd.obs_targets}}
