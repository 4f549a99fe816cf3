"""The port's ``normalize_flip_cutout`` and ``bce_with_logits_masked_sum``
(fedmlp_tpu_torch/ops/pallas_ops.py) against the JAX package's Pallas
kernels, run in interpret mode as tests/test_pallas_ops.py runs them on the
CPU, and against their jnp references. The same numpy inputs go to both. On
the CPU the port's wrappers take their plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.ops import losses as JL
from fedmlp_tpu.ops import pallas_ops as JP
from fedmlp_tpu_torch.ops import augment as A
from fedmlp_tpu_torch.ops import pallas_ops as TP
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.mark.parametrize("which", ["pallas", "jnp"])
def test_normalize_flip_cutout_matches_jax(which):
    """Mixed flips; a 16 px box, a zero box (cutout off), the whole image, a
    box cut by the border, and a box on a flipped image (the box is in output
    coordinates, filled with 127 before normalizing). rtol/atol 1e-6, the
    JAX test's own tolerance: a subtraction and a division in f32."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 32, 24, 3)).astype(np.uint8)
    flips = np.array([0, 1, 0, 1, 1], np.int32)
    boxes = np.array([[4, 6, 20, 22], [0, 0, 0, 0], [0, 0, 24, 32], [20, 28, 40, 40],
                      [2, 3, 9, 11]], np.int32)
    if which == "pallas":
        want = JP.fused_normalize_flip_cutout(imgs, flips, boxes, MEAN, STD, interpret=True)
    else:
        want = JP.reference_normalize_flip_cutout(
            jnp.asarray(imgs), jnp.asarray(flips), jnp.asarray(boxes), MEAN, STD)
    TP.reset_launch_counts()
    got = TP.normalize_flip_cutout(torch.from_numpy(imgs), torch.from_numpy(flips),
                                   torch.from_numpy(boxes), MEAN, STD)
    assert TP.LAUNCH_COUNTS["normalize_flip_cutout"] == 0  # CPU: the plain version
    assert got.shape == (5, 32, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the box holds normalized gray 127, and the flip mirrors the rest
    gray = (127.0 - 255.0 * np.float32(MEAN[0])) / (255.0 * np.float32(STD[0]))
    assert got[0, 6:22, 4:20, 0].numpy() == pytest.approx(gray, rel=1e-6)
    plain = TP.normalize_flip_cutout(torch.from_numpy(imgs), None, None, MEAN, STD)
    np.testing.assert_array_equal(got[1].numpy(), plain[1].flip(1).numpy())


@pytest.mark.parametrize("case", ["aligned", "w_not_multiple_of_4", "unaligned_base"])
def test_normalize_flip_cutout_plan_picks_four_pixels_a_thread_only_where_it_can(case):
    """Four pixels a thread needs W % 4 == 0 and 16-byte aligned bases; the
    plan decides from the tensors alone, so it runs on the CPU too."""
    H, Wd = 6, {"aligned": 8, "w_not_multiple_of_4": 7, "unaligned_base": 8}[case]
    flat = torch.zeros(3 * H * Wd * 3 + 64, dtype=torch.uint8)
    base = (-flat.data_ptr()) % 16 + (1 if case == "unaligned_base" else 0)
    imgs = flat[base:base + 2 * H * Wd * 3].view(2, H, Wd, 3)
    out = torch.empty((2, H, Wd, 3), dtype=torch.float32)
    vec4, m, s = TP.normalize_flip_cutout_plan(imgs, out, MEAN, STD)
    assert vec4 == (case == "aligned")
    assert (m, s) == (TP.norm_constants_f32(MEAN, STD))


def test_eval_batch_is_the_kernel_without_flip_or_box():
    """The test transform goes through ``normalize_flip_cutout``: NCHW, equal
    to the JAX ``eval_batch`` (rtol/atol 1e-6)."""
    from fedmlp_tpu.ops import augment as JA

    imgs = np.random.RandomState(1).randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    got = A.eval_batch(torch.from_numpy(imgs), MEAN, STD)
    assert got.shape == (3, 3, 16, 16)
    want = np.asarray(JA.eval_batch(jnp.asarray(imgs), MEAN, STD))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


def _bce_case(B, C, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, C) * 3.0).astype(np.float32)
    logits[0, :4] = [30.0, -30.0, 30.0, -30.0]
    labels = (rng.rand(B, C) < 0.4).astype(np.float32)
    labels[0, :4] = [1.0, 1.0, 0.0, 0.0]
    posw = rng.uniform(0.5, 4.0, C).astype(np.float32)
    return logits, labels, posw, rng


@pytest.mark.parametrize("mask_shape", ["BC", "C", "B1"])
def test_bce_masked_sum_value_and_gradient_match_jax(mask_shape):
    """Value against the Pallas kernel in interpret mode and the composition
    (bce_with_logits · mask).sum(): rel 1e-5 (f32 sums of 40 terms in another
    order). Gradient against jax.grad of the fused function (its closed-form
    VJP): rtol 1e-5, atol 1e-6, the JAX tests' tolerances. Logits at ±30
    stay finite. pos_weight [C]; mask [B, C], [C] or [B, 1], broadcast as
    ``_bce_sum`` broadcasts them."""
    B, C = 8, 5
    logits, labels, posw, rng = _bce_case(B, C, 2)
    mask = {"BC": (rng.rand(B, C) < 0.7), "C": (rng.rand(C) < 0.7),
            "B1": (rng.rand(B, 1) < 0.7)}[mask_shape].astype(np.float32)
    want = float(JP.fused_bce_with_logits_masked(logits, labels, posw, mask, True))
    comp = float((np.asarray(JL.bce_with_logits(logits, labels, posw)) * mask).sum())
    want_g = jax.grad(lambda x: JP.fused_bce_with_logits_masked(
        x, labels, posw, mask, True))(logits)

    x = torch.from_numpy(logits).requires_grad_(True)
    TP.reset_launch_counts()
    got = TP.bce_with_logits_masked_sum(x, torch.from_numpy(labels),
                                        torch.from_numpy(posw), torch.from_numpy(mask))
    assert TP.LAUNCH_COUNTS["bce_with_logits_masked_sum"] == 0
    assert got.shape == () and got.dtype == torch.float32 and torch.isfinite(got)
    assert float(got.detach()) == pytest.approx(want, rel=1e-5)
    assert float(got.detach()) == pytest.approx(comp, rel=1e-5)
    (got * 0.5).backward()  # an upstream cotangent other than 1
    np.testing.assert_allclose(x.grad.numpy(), 0.5 * np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(x.grad.numpy()).all()


def test_bce_masked_sum_full_pos_weight_and_only_logits_get_a_gradient():
    B, C = 6, 4
    logits, labels, _, rng = _bce_case(B, C, 3)
    posw = rng.uniform(0.5, 4.0, (B, C)).astype(np.float32)
    mask = np.ones((B, C), np.float32)
    want = float(JP.fused_bce_with_logits_masked(logits, labels, posw, mask, True))
    x = torch.from_numpy(logits).requires_grad_(True)
    pw = torch.from_numpy(posw).requires_grad_(True)
    got = TP.bce_with_logits_masked_sum(x, torch.from_numpy(labels), pw,
                                        torch.from_numpy(mask))
    assert float(got.detach()) == pytest.approx(want, rel=1e-5)
    got.backward()
    assert x.grad is not None and pw.grad is None
    # equal inputs give equal bits
    again = TP.bce_with_logits_masked_sum(x, torch.from_numpy(labels), pw,
                                          torch.from_numpy(mask))
    assert torch.equal(got.detach(), again.detach())


@pytest.mark.parametrize("pw_shape", ["C", "BC"])
@pytest.mark.parametrize("mask_shape", ["BC", "C", "B1"])
def test_bce_masked_grad_matches_jax_grad(mask_shape, pw_shape):
    """``bce_with_logits_masked_grad_ref`` and the wrapper's backward on CPU
    tensors against ``jax.grad`` of the Pallas function in interpret mode,
    with the cotangent FixMatch gives the sum, 1/(B·n_active) ≠ 1. rtol
    1e-5, atol 1e-6, the JAX tests' tolerances: the same closed form, but
    torch's and XLA's sigmoid on the CPU may differ in the last bits."""
    B, C = 9, 6
    logits, labels, posw, rng = _bce_case(B, C, 4)
    if pw_shape == "BC":
        posw = rng.uniform(0.5, 4.0, (B, C)).astype(np.float32)
    mask = {"BC": (rng.rand(B, C) < 0.7), "C": (rng.rand(C) < 0.7),
            "B1": (rng.rand(B, 1) < 0.7)}[mask_shape].astype(np.float32)
    scale = 1.0 / (B * 5)  # sup / (B · n_active) with 5 active classes
    want = scale * np.asarray(jax.grad(lambda x: JP.fused_bce_with_logits_masked(
        x, labels, posw, mask, True))(logits))

    t = {k: torch.from_numpy(v) for k, v in
         (("y", labels), ("pw", posw), ("m", mask))}
    g = torch.tensor(scale, dtype=torch.float32)
    ref = TP.bce_with_logits_masked_grad_ref(g, torch.from_numpy(logits), t["y"],
                                             t["pw"], t["m"])
    assert ref.shape == (B, C) and ref.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-6)

    x = torch.from_numpy(logits).requires_grad_(True)
    TP.reset_launch_counts()
    loss = TP.bce_with_logits_masked_sum(x, t["y"], t["pw"], t["m"]) / (B * 5)
    loss.backward()
    direct = TP.bce_with_logits_masked_grad(g, x.detach(), t["y"], t["pw"], t["m"])
    assert TP.LAUNCH_COUNTS == dict.fromkeys(TP.LAUNCH_COUNTS, 0)  # CPU: plain versions
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(direct, ref)


def test_bce_masked_sum_backward_is_none_without_a_logits_gradient():
    """Only pos_weight asks for a gradient: the backward gives None and
    computes nothing."""
    logits, labels, posw, _ = _bce_case(3, 4, 5)
    pw = torch.from_numpy(posw).requires_grad_(True)
    x = torch.from_numpy(logits)
    got = TP.bce_with_logits_masked_sum(x, torch.from_numpy(labels), pw,
                                        torch.ones((3, 4)))
    assert got.requires_grad
    got.backward()
    assert pw.grad is None


@pytest.mark.parametrize("bad", ["images", "flips", "boxes", "labels", "mask", "dtype"])
def test_wrappers_reject_bad_inputs(bad):
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    flips = torch.zeros(2, dtype=torch.int32)
    boxes = torch.zeros((2, 4), dtype=torch.int32)
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        if bad == "images":
            TP.normalize_flip_cutout(imgs.float(), flips, boxes, MEAN, STD)
        elif bad == "flips":
            TP.normalize_flip_cutout(imgs, flips.long(), boxes, MEAN, STD)
        elif bad == "boxes":
            TP.normalize_flip_cutout(imgs, flips, boxes[:, :3], MEAN, STD)
        elif bad == "labels":
            TP.bce_with_logits_masked_sum(x, torch.zeros((2, 4)), torch.ones(3), x)
        elif bad == "mask":
            TP.bce_with_logits_masked_sum(x, x, torch.ones(3), torch.ones((3, 1)))
        else:
            TP.bce_with_logits_masked_sum(x.double(), x, torch.ones(3), x)
