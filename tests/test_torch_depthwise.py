"""The port's depthwise backward (fedmlp_tpu_torch/ops/dw_pallas.py,
ops/depthwise.py, the ``dw_backend='pallas'`` EfficientNet) against the JAX
package's Pallas kernels run in interpret mode, and against
``torch.autograd`` through ``F.conv2d`` as a second, independent reference.

Everything runs float32 on the CPU, where the port's wrappers take the
kernels' plain versions; inputs come from seeded numpy generators. The JAX
functions are NHWC with filters [k, k, 1, C]; the port is NCHW with
[C, 1, k, k], so the tests permute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedmlp_tpu.models.efficientnet import _same_pads, efficientnet_b0 as j_b0
from fedmlp_tpu.ops.dw_pallas import dw_conv_flat_s1, dw_conv_pallas as j_dw_conv_pallas
from fedmlp_tpu_torch.models import build_model
from fedmlp_tpu_torch.models.layers import same_pads
from fedmlp_tpu_torch.ops import dw_pallas as T
from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas
from fedmlp_tpu_torch.weights import from_jax_variables, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_variables import flax_shapes, numpy_variables


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(w):
    """[k, k, 1, C] → [C, 1, k, k]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _inputs(seed, hw, c, k, batch=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, hw, hw, c).astype(np.float32)
    w = rs.randn(k, k, 1, c).astype(np.float32)
    return rs, x, w


@pytest.mark.parametrize("hw,c,k,pads", [
    (12, 8, 3, None), (8, 4, 3, None), (8, 16, 5, None), (14, 32, 3, None),
    (9, 5, 5, ((1, 3), (4, 0))),  # uneven pad split
    (7, 6, 5, ((3, 1), (0, 4))),  # more padding than data
])
def test_conv_s1_ref_matches_jax_kernel(hw, c, k, pads):
    """``dw_conv_s1_ref`` (the JAX kernel's interface in plain PyTorch, which
    the strided tests build on) against the Pallas conv kernel in interpret
    mode; rtol/atol 1e-5: both sum k² float32 products, in tap order."""
    _, x, w = _inputs(0, hw, c, k)
    pads = pads or (_same_pads(hw, k, 1), _same_pads(hw, k, 1))
    want = dw_conv_flat_s1(jnp.asarray(x), jnp.asarray(w), pads, interpret=True)
    got = T.dw_conv_s1_ref(_nchw(x), _oihw(w), pads)
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), rtol=1e-5, atol=1e-5)


def test_same_pads_equal_jax():
    for n in (7, 14, 15, 112, 224):
        for k in (3, 5):
            for s in (1, 2):
                assert same_pads(n, k, s) == _same_pads(n, k, s)


@pytest.mark.parametrize("hw,c,k,s", [
    (12, 8, 3, 1), (12, 8, 3, 2), (8, 16, 5, 2), (14, 32, 3, 2),
    (8, 4, 5, 1), (16, 8, 5, 2),
])
def test_vjp_matches_jax_pallas_vjp(hw, c, k, s):
    """dx and dw of the port's autograd function against ``jax.vjp`` of the
    JAX ``dw_conv_pallas`` (interpret mode) on a shared cotangent: rtol
    1e-5, atol 1e-4 (dw sums B·H·W float32 products in another order)."""
    rs, x, w = _inputs(1, hw, c, k)
    pads = (_same_pads(hw, k, s), _same_pads(hw, k, s))
    yj, vjp = jax.vjp(lambda x, w: j_dw_conv_pallas(x, w, s, pads, True),
                      jnp.asarray(x), jnp.asarray(w))
    ct = rs.randn(*yj.shape).astype(np.float32)
    dxj, dwj = vjp(jnp.asarray(ct))

    xt = _nchw(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    yt = T.dw_conv_pallas(xt, wt, s, pads)
    np.testing.assert_allclose(yt.detach().numpy(), _nchw(yj).numpy(),
                               rtol=1e-5, atol=1e-5)
    yt.backward(_nchw(ct))
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(dxj).numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), _oihw(dwj).numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hw,c,k,s", [
    (12, 8, 3, 1), (15, 8, 3, 2), (14, 6, 5, 2), (7, 4, 5, 1), (9, 5, 5, 2),
])
def test_vjp_matches_torch_autograd(hw, c, k, s):
    """The same gradients against PyTorch's own backward of ``F.conv2d`` on
    the TF-SAME padded input (odd sizes included): rtol 1e-5, atol 1e-4."""
    rs, x, w = _inputs(2, hw, c, k, batch=3)
    pads = (same_pads(hw, k, s), same_pads(hw, k, s))
    (pt, pb), (pl, pr) = pads
    x1, w1 = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    x2, w2 = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    y1 = T.dw_conv_pallas(x1, w1, s, pads)
    y2 = F.conv2d(F.pad(x2, (pl, pr, pt, pb)), w2, None, s, 0, 1, c)
    assert torch.equal(y1, y2)  # the forward is that very call
    ct = torch.from_numpy(rs.randn(*y1.shape).astype(np.float32))
    y1.backward(ct)
    y2.backward(ct)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-5, atol=1e-4)


def test_plain_versions_take_bf16_inputs():
    """bf16 inputs, float32 accumulation: against the float32 run on the
    same (bf16-rounded) values, dx differs only by its final rounding to
    bf16 (one ulp, 2^-7 relative) and dw, returned in float32, not at all."""
    rs, x, w = _inputs(3, 10, 6, 5)
    pads = ((1, 3), (2, 2))
    dyb, wb = _nchw(x).bfloat16(), _oihw(w).bfloat16()
    xb = torch.from_numpy(rs.randn(2, 6, 10, 10).astype(np.float32)).bfloat16()
    got = T.dw_dgrad(dyb, wb, 1, pads, (10, 10))
    want = T.dw_dgrad(dyb.float(), wb.float(), 1, pads, (10, 10))
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want).abs() <= want.abs() * 2.0 ** -7 + 1e-6).all())
    dw = T.dw_wgrad(xb, dyb, 5, 1, pads)
    assert dw.dtype == torch.float32 and dw.shape == (6, 1, 5, 5)
    assert torch.equal(dw, T.dw_wgrad(xb.float(), dyb.float(), 5, 1, pads))


def test_module_casts_like_conv2d_under_autocast():
    """Under CPU bf16 autocast the module computes as ``nn.Conv2d`` does
    (inputs and weight rounded to bf16, bf16 output) and hands the float32
    parameter a float32 gradient equal to the bf16-rounded dw."""
    torch.manual_seed(0)
    m = DepthwisePallas(4, 3, 2)
    torch.nn.init.normal_(m.weight)
    ref = torch.nn.Conv2d(4, 4, 3, 2, groups=4, bias=False)
    ref.weight.data.copy_(m.weight.data)
    x = torch.randn(2, 4, 8, 8)
    pads = (same_pads(8, 3, 2), same_pads(8, 3, 2))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = m(x, pads)
        y_ref = ref(F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1])))
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_ref)
    y.float().sum().backward()
    assert m.weight.grad.dtype == torch.float32
    want = T.dw_wgrad_ref(x.bfloat16(), torch.ones_like(y), 3, 2, pads).bfloat16().float()
    assert torch.equal(m.weight.grad, want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 2, 4, 4)
    w = torch.zeros(2, 1, 3, 3)
    pads = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="does not match"):
        T.dw_dgrad(x, w, 1, ((1, 0), (1, 1)), (4, 4))
    with pytest.raises(ValueError, match="match the cotangent's type"):
        T.dw_dgrad(x, w.bfloat16(), 1, pads, (4, 4))
    with pytest.raises(ValueError, match=r"w must be \[2, 1, k, k\]"):
        T.dw_dgrad(x, torch.zeros(3, 1, 3, 3), 1, pads, (4, 4))
    with pytest.raises(ValueError, match="must be"):
        T.dw_wgrad(x, torch.zeros(1, 2, 2, 2), 3, 1, pads)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        T.dw_wgrad(x.double(), x.double(), 3, 1, pads)
    with pytest.raises(ValueError, match="does not fit"):
        T.dilate_to_input(torch.zeros(1, 1, 4, 4), 2, 6, 6)


def test_wgrad_plan_covers_every_item():
    """The launch plan of ``dw_wgrad`` at the 16 EfficientNet-B0 shapes
    (B=32, 224 px, bf16) and an odd one: row tiles where a row is at least 56
    values of whole 16-byte vectors, whole-plane channel groups elsewhere;
    at least one and at most as many blocks a channel (group) as there are
    items, shared memory within the opt-in limit. (The read bounds of every
    item: tests/test_torch_dw_strided.py.)"""
    shapes = [(32, 112, 3, 1), (96, 112, 3, 2), (144, 56, 3, 1), (144, 56, 5, 2),
              (240, 28, 5, 1), (240, 28, 3, 2), (480, 14, 3, 1), (480, 14, 5, 1),
              (672, 14, 5, 1), (672, 14, 5, 2), (1152, 7, 5, 1), (1152, 7, 3, 1),
              (5, 9, 5, 1)]
    for C, hw, k, s in shapes:
        pt, pb = same_pads(hw, k, s)
        ho = (hw + pt + pb - k) // s + 1
        p = T.wgrad_plan(32, C, hw, hw, ho, ho, k, s, pt, pt, 2)
        assert p.rows == (hw >= 56 and ho % 8 == 0)
        if p.rows:
            assert 1 <= p.th <= ho and p.group == 1
            assert 1 <= p.splits <= 32 * -(-ho // p.th)
        else:
            assert p.group in (1, 2, 4, 8, 16, 32, 64)
            assert 1 <= p.splits <= 32
        assert p.smem <= T.SMEM_LIMIT


def _b0_pair(n_classes=3):
    conv = build_model("efficient_b0", n_classes, dw_backend="conv",
                       dropout_p=0.0, drop_connect_rate=0.0)
    pallas = build_model("efficient_b0", n_classes, dw_backend="pallas",
                         dropout_p=0.0, drop_connect_rate=0.0)
    return conv, pallas


def test_b0_pallas_backend_matches_conv_backend_and_flax():
    """EfficientNet-B0 at 64 px, batch 2, train mode, loss Σ logits²: the
    port's 'pallas' model against the port's 'conv' model (same
    ``state_dict``) and against flax's model with the exact depthwise
    convolution (``dw_backend='conv'``) with the same weights through
    weights.py. Logits within 1e-4; parameter gradients within rtol 2e-2,
    atol 2e-3 (the JAX package's own tolerance between its backends). The
    JAX package's tests/test_depthwise.py::test_b0_pallas_backend_grads_match
    holds its 'pallas' B0 to its 'conv' B0 at this geometry and tolerance,
    and test_vjp_matches_jax_pallas_vjp above the port's backward to the
    JAX Pallas kernels in interpret mode layer by layer. The weights are
    drawn with numpy in flax's shapes (tests/torch_variables.py), not by
    either package's init; flax's gradient is jitted."""
    jm = j_b0(3, dtype=jnp.float32, dw_backend="conv", dropout_p=0.0,
              drop_connect_rate=0.0)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    conv, pallas = _b0_pair()
    v = numpy_variables(flax_shapes(jm, 64, train=False), 0)
    sd = from_jax_variables(v)

    def jloss(params):
        (_, logits), _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                                  x, train=True, mutable=["batch_stats"])
        return jnp.sum(logits ** 2), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    want = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    assert list(conv.state_dict()) == list(pallas.state_dict())
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    grads = {}
    for name, m in (("conv", conv), ("pallas", pallas)):
        m.load_state_dict(sd, strict=True)
        m.train()
        _, logits = m(xt)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-4, err_msg=name)
        (logits ** 2).sum().backward()
        grads[name] = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert set(grads["pallas"]) == set(want)
    for n, g in grads["pallas"].items():
        np.testing.assert_allclose(g, grads["conv"][n], rtol=2e-2, atol=2e-3, err_msg=n)
        np.testing.assert_allclose(g, want[n].numpy(), rtol=2e-2, atol=2e-3, err_msg=n)


def test_pallas_model_weights_round_trip_through_flax_tree():
    """A flax ``dw_backend='pallas'`` tree loads into the port's 'pallas'
    model (strict) and comes back bit for bit: the depthwise parameter
    keeps the grouped conv's name and shape."""
    jm = j_b0(4, dtype=jnp.float32, dw_backend="pallas")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3)), train=False))
    rs = np.random.RandomState(0)
    v = jax.tree_util.tree_map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    _, pallas = _b0_pair(4)
    pallas.load_state_dict(from_jax_variables(v), strict=True)
    assert pallas.block1_0.dw_conv.weight.shape == (96, 1, 3, 3)
    back = to_jax_variables(pallas.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
