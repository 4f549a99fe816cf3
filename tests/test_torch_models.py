"""The port's models (fedmlp_tpu_torch/models) against the JAX package's flax
models, with the same weights carried over by fedmlp_tpu_torch/weights.py
and the same numpy inputs (NHWC for flax, NCHW for the port).

Tolerance atol 1e-4 in float32: the two frameworks order their convolution
and reduction sums differently, a few ulps per layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.models import efficientnet as JE
from fedmlp_tpu.models import smallcnn as JS
from fedmlp_tpu_torch.models import build_model, efficientnet as TE, init_model
from fedmlp_tpu_torch.models import smallcnn as TS
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL = 1e-4
# narrow, shallow EfficientNet from the same parameters: three block stages
# (one with a residual repeat), width 0.5
BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 1, 2, 5))


@functools.lru_cache(maxsize=None)
def _flax(name):
    """flax's module of ``name``, its variables (one init a process; the
    tests only read them) and its forward, jitted once a process for each
    mode: one compile of the whole graph costs less than an eager forward,
    which compiles each op."""
    if name == "efficientnet":
        jm = JE.EfficientNet(0.5, 1.0, 5, dtype=jnp.float32, blocks=BLOCKS,
                             dropout_p=0.0, drop_connect_rate=0.0)
    else:
        jm = JS.SmallCNN(5)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((2, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, v)
    # non-trivial running stats, so eval mode tests them too
    rng = np.random.RandomState(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.rand(*a.shape).astype(np.float32) * 0.5), v["batch_stats"])
    apply = {False: jax.jit(lambda v, x: jm.apply(v, x, train=False)),
             True: jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))}
    return jm, v, apply


def _pair(name):
    jm, v, _ = _flax(name)
    if name == "efficientnet":
        tm = TE.EfficientNet(0.5, 1.0, 5, blocks=BLOCKS, dropout_p=0.0,
                             drop_connect_rate=0.0)
    else:
        tm = TS.SmallCNN(5)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, tm, v


@pytest.mark.parametrize("name", ["efficientnet", "smallcnn"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(name, train):
    """(feature, logits) in eval and train mode; in train mode also the
    batch-norm running stats after one forward. Batch 2 at 33 px (odd, so
    the TF-SAME pads are asymmetric) leaves 2-4 values per channel in the
    last layers, where flax's biased variance and nn.BatchNorm2d's
    unbiased one differ by a factor of up to 2."""
    _, tm, v = _pair(name)
    apply = _flax(name)[2][train]
    x = np.random.RandomState(2).randn(2, 33, 33, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tm.train(train)
    ft, lt = tm(xt)
    if train:
        (fj, lj), mut = apply(v, x)
        want_stats = from_jax_variables(
            {"batch_stats": jax.tree_util.tree_map(np.asarray, mut["batch_stats"])})
        sd = tm.state_dict()
        for k, w in want_stats.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=ATOL,
                                       err_msg=k)
    else:
        fj, lj = apply(v, x)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["efficientnet", "smallcnn"])
def test_weights_round_trip(name):
    """from_jax_variables then to_jax_variables gives back the same tree,
    bit for bit."""
    _, tm, v = _pair(name)
    back = to_jax_variables(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_efficientnet_b0_matches_jax_layout():
    """Full-width B0: every flax variable maps onto a port variable of the
    same shape, and the counts agree (traced by shape only)."""
    jm = JE.efficientnet_b0(8, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 224, 224, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    mapped = from_jax_variables(zeros)
    sd = build_model("efficient_b0", 8).state_dict()
    assert set(mapped) == set(sd)
    for k, t in sd.items():
        assert tuple(mapped[k].shape) == tuple(t.shape), k
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in build_model("efficient_b0", 8).parameters())
    assert n_port == n_jax


def test_init_draws_from_flax_default_distributions():
    """lecun-normal kernels (truncated at 2σ, variance 1/fan_in), zero
    biases, batch-norm scale 1 / bias 0: compare per-layer std with flax's
    init of the same layer within 10% (layers of ≥ 4096 weights)."""
    jm = JE.efficientnet_b0(8, dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(0))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, v))
    tm = init_model(build_model("efficient_b0", 8), seed=0)
    sd = tm.state_dict()
    for k, w in want.items():
        got = sd[k]
        if k.endswith("bias") or k.endswith("running_mean"):
            assert torch.count_nonzero(got) == 0, k
        elif got.dim() == 1:  # batch-norm scale, running var
            assert torch.all(got == 1.0), k
        elif got.numel() >= 4096:
            ratio = float(got.std()) / float(w.std())
            assert 0.9 < ratio < 1.1, (k, ratio)
            sigma = (1.0 / got[0].numel()) ** 0.5 / 0.87962566103423978
            assert float(got.abs().max()) <= 2.0 * sigma * (1 + 1e-6), k
