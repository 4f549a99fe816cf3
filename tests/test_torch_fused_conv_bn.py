"""The port's fused 1×1-conv + batch-norm kernels (plain versions, on the CPU)
against tools/fused_conv_bn.py run in Pallas interpret mode.

Both sides get the same numpy inputs. Tolerances:
  * f32 y and out: both sides sum the Ci products of an element in their own
    order, so they may differ by the rounding of a Ci-term f32 sum:
    2·Ci·2⁻²⁴·Σ_k|x_k·w_k| for y, that times |mul| (plus the statistics'
    difference, below) for out, and 1e-6·(1 + |out|) for the sigmoid.
  * bf16 y: the f32 values round to the same bf16 value or to a neighbour:
    at most one bf16 ulp apart; bf16 out: one ulp beyond the f32 bound.
  * sum and sum of squares within 1e-5 relative to Σ|y| and Σy² (f32 sums
    of M terms in another order); mean and var the same divided by M.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu_torch.ops import fused_conv_bn as F
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fused_conv_bn as J  # noqa: E402

SHAPES = [(2048, 16, 96, 512), (392, 80, 480, None)]


def _inputs(M, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(M, Ci).astype(np.float32), rs.randn(Ci, Co).astype(np.float32),
            (rs.rand(Co) + 0.5).astype(np.float32), rs.randn(Co).astype(np.float32))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _product_scale(x, w):
    return np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))


def _out_tol(x, w, y, scale, mean, var, jmean, jvar, act):
    """Bound on |out − JAX's out| before the final cast, out = act(y·mul +
    add): y's difference scaled by |mul|, plus the folded statistics'
    difference |y|·Δmul + Δadd (large against out only where y·mul + add
    cancels to near zero), times the activation's slope."""
    jm, jv = np.asarray(jmean, np.float64), np.asarray(jvar, np.float64)
    mul = scale / np.sqrt(jv + 1e-3)
    d_mul = np.abs(1.0 / np.sqrt(var + 1e-3) - 1.0 / np.sqrt(jv + 1e-3)) * scale
    d_add = np.abs(mean - jm) * mul + np.abs(jm) * d_mul
    slope = 1.1 if act == "swish" else 1.0  # |d swish/dz| < 1.1
    d_y = 2 * x.shape[1] * 2.0 ** -24 * _product_scale(x, w)
    return slope * (d_y * mul + np.abs(y) * d_mul + d_add)


def _assert_stats(s, ss, s_want, ss_want, y):
    y = np.asarray(y, np.float64)
    np.testing.assert_allclose(s, s_want, rtol=0, atol=1e-5 * np.abs(y).sum())
    np.testing.assert_allclose(ss, ss_want, rtol=0, atol=1e-5 * (y * y).sum())


@pytest.mark.parametrize("M,Ci,Co,tile_m", SHAPES)
def test_conv1x1_bn_stats_plain_version_matches_jax(M, Ci, Co, tile_m):
    x, w, _, _ = _inputs(M, Ci, Co)
    jy, js, jss = J.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w), tile_m=tile_m,
                                     interpret=True)
    F.reset_launch_counts()
    y, s, ss = F.conv1x1_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    assert F.LAUNCH_COUNTS["conv1x1_bn_stats"] == 0  # the CPU takes the plain version
    assert y.shape == (M, Co) and y.dtype == torch.float32
    assert s.dtype == ss.dtype == torch.float32 and s.shape == ss.shape == (Co,)
    tol = 2 * Ci * 2.0 ** -24 * _product_scale(x, w)
    assert (np.abs(y.numpy() - np.asarray(jy)) <= tol).all()
    _assert_stats(s.numpy(), ss.numpy(), np.asarray(js), np.asarray(jss), jy)


@pytest.mark.parametrize("act", ["swish", "identity"])
@pytest.mark.parametrize("M,Ci,Co,tile_m", SHAPES)
def test_conv1x1_bn_act_2pass_plain_version_matches_jax(M, Ci, Co, tile_m, act):
    x, w, scale, bias = _inputs(M, Ci, Co, seed=1)
    jout, jmean, jvar = J.conv1x1_bn_act_2pass(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        eps=1e-3, act=act, tile_m=tile_m, interpret=True)
    out, mean, var = F.conv1x1_bn_act_2pass(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), eps=1e-3, act=act)
    y = np.asarray(J.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w), tile_m=tile_m,
                                      interpret=True)[0], np.float64)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-5 * np.abs(y).sum() / M)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0,
                               atol=2e-5 * (y * y).sum() / M)
    tol = _out_tol(x, w, y, scale, mean.numpy(), var.numpy(), jmean, jvar, act)
    assert out.dtype == torch.float32 and out.shape == (M, Co)
    tol = tol + 1e-6 * (1.0 + np.abs(np.asarray(jout)))  # the sigmoid's rounding
    assert (np.abs(out.numpy() - np.asarray(jout)) <= tol).all()
    if act != "swish":  # the identity leaves a normalized product: mean 0
        assert np.abs(out.numpy().mean(0) - bias).max() < 1e-3


def test_bf16_plain_versions_match_jax_within_one_ulp():
    """bf16 x and w, f32 sums: y at most one bf16 ulp from JAX's, out one
    bf16 ulp beyond the f32 bound of ``_out_tol``; the statistics within
    1e-5 relative to Σ|y| and Σy²."""
    M, Ci, Co = 2048, 16, 96
    x, w, scale, bias = _inputs(M, Ci, Co, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(wb.float().numpy(), jnp.bfloat16)

    jy, js, jss = J.conv1x1_bn_stats(xj, wj, tile_m=512, interpret=True)
    y, s, ss = F.conv1x1_bn_stats(xb, wb)
    assert y.dtype == torch.bfloat16
    jy32 = np.asarray(jy.astype(jnp.float32))
    assert (np.abs(y.float().numpy() - jy32) <= _bf16_ulp(jy32)).all()
    _assert_stats(s.numpy(), ss.numpy(), np.asarray(js), np.asarray(jss), jy32)

    jout, jmean, jvar = J.conv1x1_bn_act_2pass(xj, wj, jnp.asarray(scale),
                                               jnp.asarray(bias), tile_m=512,
                                               interpret=True)
    out, mean, var = F.conv1x1_bn_act_2pass(xb, wb, torch.from_numpy(scale),
                                            torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    jout32 = np.asarray(jout.astype(jnp.float32))
    tol = _bf16_ulp(jout32) + _out_tol(x, w, jy32, scale, mean.numpy(), var.numpy(),
                                       jmean, jvar, "swish")
    assert (np.abs(out.float().numpy() - jout32) <= tol).all()
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-5 * np.abs(jy32).sum() / M)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0,
                               atol=2e-5 * (jy32.astype(np.float64) ** 2).sum() / M)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError):
        F.conv1x1_bn_stats(x, torch.zeros((5, 3)))  # Ci mismatch
    with pytest.raises(ValueError):
        F.conv1x1_bn_stats(x, torch.zeros((4, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        F.conv1x1_bn_stats(x.double(), torch.zeros((4, 3), dtype=torch.float64))


def test_card_check_takes_a_reordered_bf16_sum_and_refuses_a_dropped_term():
    """chip_smoke.py's bf16 y check (``_y_excess_ulps``: one bf16 ulp beyond
    the reordered-sum bound 2·Ci·2⁻²⁴·Σ_k|x_k·w_k|, on at most 1% of the
    elements), run on the CPU: the product summed over k in reverse order
    passes it; the product without its k = 0 term fails it."""
    import chip_smoke

    rs = np.random.RandomState(3)
    M, Ci, Co = 256, 24, 40
    x = torch.from_numpy(rs.randn(M, Ci).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rs.randn(Ci, Co).astype(np.float32)).to(torch.bfloat16)
    y = F._product_ref(x, w)
    yr = y.to(torch.bfloat16)
    xf, wf = x.float(), w.float()
    rev = torch.zeros((M, Co))
    for k in reversed(range(Ci)):
        rev = rev + xf[:, k:k + 1] * wf[k]
    assert not torch.equal(rev, y)  # another order, other roundings
    dropped = F._product_ref(x[:, 1:], w[1:])

    def passes(got):
        u = chip_smoke._y_excess_ulps(got.to(torch.bfloat16), yr, x, w, torch.bfloat16)
        return float(u.max()) <= 1.0 and float((u > 0).float().mean()) <= 0.01

    assert passes(rev)
    assert not passes(dropped)
    # f32 keeps the plain version's order: no bound, so the reordered sum
    # is held to one f32 ulp on at most 1% of the elements, and fails that
    u32 = chip_smoke._y_excess_ulps(rev, y, xf, wf, torch.float32)
    assert float((u32 > 0).float().mean()) > 0.01


def test_launches_into_a_given_tensor_refuse_cpu_tensors():
    """``*_into`` write into the caller's tensor on the card; with CPU tensors
    they raise rather than take the plain version."""
    x = torch.zeros((8, 4))
    w = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        F.conv1x1_bn_stats_into(x, w, torch.empty((8, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        F.conv1x1_bn_act_2pass_into(x, w, torch.ones(3), torch.zeros(3), torch.empty((8, 3)))
