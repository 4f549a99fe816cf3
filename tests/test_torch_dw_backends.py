"""The port's depthwise backends 'taps', 'dense' and 'reroute'
(fedmlp_tpu_torch/ops/depthwise.py, ops/dw_conv.py, the EfficientNet
``dw_backend``) against the JAX package's functions and models on the CPU,
where none of them reaches a Pallas kernel.

Inputs come from seeded numpy generators. The JAX functions are NHWC with
filters [k, k, 1, C]; the port is NCHW with [C, 1, k, k], so the tests
permute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.models.efficientnet import _same_pads, efficientnet_b0 as j_b0
from fedmlp_tpu.ops import depthwise as JD
from fedmlp_tpu.ops import dw_conv as JC
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.models.efficientnet import DW_BACKENDS
from fedmlp_tpu_torch.ops import depthwise as TD
from fedmlp_tpu_torch.ops import dw_conv as TC
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_variables import flax_shapes, numpy_variables

# (port function, JAX function) of each backend
_OPS = {
    "taps": (TD.depthwise_taps, JD.depthwise_taps),
    "dense": (TD.depthwise_dense, JD.depthwise_dense),
    "reroute": (TC.dw_conv, JC.dw_conv),
}
# B0's depthwise layers of at most 192 channels: the 'dense' ones
_DENSE_B0 = {"block0_0", "block1_0", "block1_1", "block2_0"}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                 .transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32)
                                                 .transpose(3, 2, 0, 1)))


def _vjp_both(name, x, w, ct, s, pads, dtype):
    """(y, dx, dw) of the port's and of JAX's function on the same inputs
    and cotangent, each as float32 numpy in the port's layout."""
    t_fn, j_fn = _OPS[name]

    @jax.jit
    def jax_vjp(x, w, ct):  # one compile, not one an op
        y, vjp = jax.vjp(lambda a, b: j_fn(a, b, s, pads), x, w)
        return (y,) + vjp(ct)

    yj, dxj, dwj = jax_vjp(*(jnp.asarray(a, dtype) for a in (x, w, ct)))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = _nchw(x).to(tdt).requires_grad_()
    wt = _oihw(w).to(tdt).requires_grad_()
    yt = t_fn(xt, wt, s, pads)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), _nchw(ct).to(tdt))
    port = [t.detach().float().numpy() for t in (yt, dxt, dwt)]
    jx = [_nchw(yj).numpy(), _nchw(dxj).numpy(), _oihw(dwj).numpy()]
    return port, jx


@pytest.mark.parametrize("name", sorted(_OPS))
@pytest.mark.parametrize("k,s,hw", [(3, 1, 14), (3, 2, 15), (5, 1, 15), (5, 2, 14)])
def test_ops_match_jax_in_float32(name, k, s, hw):
    """Forward, dx and dw against JAX's ``depthwise_taps``/
    ``depthwise_dense``/``dw_conv`` at k ∈ {3, 5}, s ∈ {1, 2}, odd and even
    H, float32: within 1e-5 of the largest magnitude of each output."""
    rs = np.random.RandomState(k * 10 + s + hw)
    x = rs.randn(2, hw, hw, 8).astype(np.float32)
    w = rs.randn(k, k, 1, 8).astype(np.float32)
    pads = (_same_pads(hw, k, s), _same_pads(hw, k, s))
    ct = rs.randn(2, -(-hw // s), -(-hw // s), 8).astype(np.float32)
    port, jx = _vjp_both(name, x, w, ct, s, pads, jnp.float32)
    for what, a, b in zip(("y", "dx", "dw"), port, jx):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("name", sorted(_OPS))
def test_ops_match_jax_in_bfloat16(name):
    """The same in bfloat16 at k=5, s=2 (odd H): y and dx within 2e-2 of the
    largest magnitude, dw within 5e-2. XLA on the CPU may keep float32
    between the tap products and sums of one fusion, where torch rounds
    every product and sum to bfloat16 (8-bit mantissa, 25 taps); dw sums
    B·H'·W' = 128 bfloat16 products in another order on each side."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 15, 15, 8).astype(np.float32)
    w = rs.randn(5, 5, 1, 8).astype(np.float32)
    pads = (_same_pads(15, 5, 2), _same_pads(15, 5, 2))
    ct = rs.randn(2, 8, 8, 8).astype(np.float32)
    port, jx = _vjp_both(name, x, w, ct, 2, pads, jnp.bfloat16)
    for what, a, b, tol in zip(("y", "dx", "dw"), port, jx, (2e-2, 2e-2, 5e-2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("name", sorted(_OPS))
def test_modules_cast_to_the_autocast_type(name):
    """Under bfloat16 autocast a backend module computes in bfloat16 and the
    float32 parameter receives a float32 gradient through the cast."""
    m = init_model(build_model("efficient_b0", 3, dw_backend=name), 0).block1_0.dw_conv
    x = torch.randn(2, 96, 16, 16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = m(x, ((0, 1), (0, 1)))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 96, 8, 8)
    y.float().sum().backward()
    assert m.weight.grad.dtype == torch.float32 and m.weight.grad.abs().sum() > 0


def test_state_dicts_fit_every_backend_and_dense_takes_four_layers():
    """One ``state_dict`` loads strictly into B0 of all five backends (the
    one parameter ``dw_conv.weight`` [C, 1, k, k] each), and 'dense' builds
    exactly the four depthwise layers of at most 192 channels; the other 12
    stay the grouped ``nn.Conv2d``."""
    sd = init_model(build_model("efficient_b0", 3), 0).state_dict()
    for be in DW_BACKENDS:
        m = build_model("efficient_b0", 3, dw_backend=be)
        m.load_state_dict(sd, strict=True)
        assert [(n, v.shape) for n, v in m.state_dict().items()] == \
            [(n, v.shape) for n, v in sd.items()]
    m = build_model("efficient_b0", 3, dw_backend="dense")
    dense = {n for n in m.block_names
             if isinstance(getattr(m, n).dw_conv, TD.DepthwiseDense)}
    grouped = {n for n in m.block_names
               if type(getattr(m, n).dw_conv) is torch.nn.Conv2d}
    assert dense == _DENSE_B0 and len(grouped) == 12 and not dense & grouped


@pytest.mark.parametrize("cap,want", [("96", {"block0_0", "block1_0"}), ("0", set()),
                                      ("192", _DENSE_B0)])
def test_dense_channel_cap_reads_the_environment(monkeypatch, cap, want):
    """``FEDMLP_DW_DENSE_MAXCH`` moves the cap, as in the JAX package
    (read when the model is built)."""
    monkeypatch.setenv("FEDMLP_DW_DENSE_MAXCH", cap)
    m = build_model("efficient_b0", 3, dw_backend="dense")
    assert {n for n in m.block_names
            if isinstance(getattr(m, n).dw_conv, TD.DepthwiseDense)} == want


@pytest.fixture(scope="module")
def flax_b0():
    """flax's EfficientNet-B0 with the exact depthwise convolution
    (``dw_backend='conv'``) at 32 px, batch 2, float32, loss Σ logits²:
    the weights (drawn with numpy in flax's shapes, tests/torch_variables.py),
    the input, the logits and every parameter gradient, computed once a
    module for the three backends."""
    jm = j_b0(3, dtype=jnp.float32, dw_backend="conv")
    v = numpy_variables(flax_shapes(jm, 32, train=False), 1)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)

    def jloss(params):
        _, logits = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                             train=False)
        return jnp.sum(logits ** 2), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    want = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    return v, x, np.asarray(jlogits), want


@pytest.mark.parametrize("backend", ["taps", "dense", "reroute"])
def test_b0_backend_matches_jax_b0(flax_b0, backend):
    """The port's B0 with each backend against flax's B0 with the exact
    depthwise convolution (``flax_b0``), the same weights carried by
    weights.py: logits and every parameter gradient within 1e-4 of the
    largest magnitude of each. Each backend's own function is held to the
    JAX package's function of the same backend above, and the JAX package's
    tests/test_depthwise.py holds its 'taps' and 'dense' B0 to its 'conv'
    B0. Batch norm runs on its running statistics (eval mode): in train
    mode the last stages at 1x1 normalize over 2 values a channel, where
    both frameworks' float32 rounding is amplified past any fixed tolerance
    (see tests/test_torch_backbones.py); the depthwise forward and backward
    are the same either way."""
    v, x, jl, want = flax_b0
    tm = build_model("efficient_b0", 3, dw_backend=backend)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tm.eval()
    _, logits = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(logits.detach().numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    (logits ** 2).sum().backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = want[n].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=n)
