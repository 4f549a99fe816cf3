"""The port's normalize constants against the JAX package's, to the bit.

Every normalization of the JAX package forms 255·mean and 255·std as the f32
product of f32 mean and std (``fedmlp_tpu/ops/augment.py::normalize``, the
normalize/flip/cutout kernel and its reference), except the weak-view warp
kernel, which bakes ``float(mean[c]) * 255.0`` rounded once into its body.
For std 0.224 the two differ (57.120003 against 57.12), and on a 0..255 ramp
the green channel then differs by one ulp on 204 of the 256 levels. So the
port keeps both: ``norm_constants_f32`` for ``normalize_planar`` and the
``normalize_flip_cutout`` kernel, ``norm_constants`` for the warp kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.ops import augment as JA
from fedmlp_tpu_torch.ops import pallas_ops as TP
from fedmlp_tpu_torch.ops import warp as W
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _ramp_u8() -> np.ndarray:
    """[1, 1, 256, 3]: every gray level in every channel."""
    return np.repeat(np.arange(256, dtype=np.uint8)[None, None, :, None], 3, axis=3)


def _levels_that_differ(got: np.ndarray, want: np.ndarray) -> list:
    """Per channel, how many of the 256 levels differ in their bits."""
    return [int((got[..., c].view(np.uint32) != want[..., c].view(np.uint32)).sum())
            for c in range(3)]


def test_normalize_planar_equals_jax_normalize_bit_for_bit():
    ramp = _ramp_u8()
    want = np.asarray(JA.normalize(jnp.asarray(ramp, jnp.float32), MEAN, STD))
    x = torch.from_numpy(ramp).permute(0, 3, 1, 2).to(torch.float32)
    got = W.normalize_planar(x, MEAN, STD).permute(0, 2, 3, 1).numpy()
    assert _levels_that_differ(got, want) == [0, 0, 0]


def test_normalize_flip_cutout_kernel_constants_give_jax_eval_batch_bit_for_bit():
    """The constants the wrapper hands its kernel, through the kernel's own
    table entry (v − m_c)/s_c for every level v, against ``eval_batch``."""
    ramp = _ramp_u8()
    want = np.asarray(JA.eval_batch(jnp.asarray(ramp), MEAN, STD))
    imgs = torch.from_numpy(ramp)
    out = torch.empty(imgs.shape, dtype=torch.float32)
    _, m, s = TP.normalize_flip_cutout_plan(imgs, out, MEAN, STD)
    v = imgs.to(torch.float32)
    got = torch.stack([(v[..., c] - torch.tensor(m[c])) / torch.tensor(s[c])
                       for c in range(3)], dim=-1).numpy()
    assert got.dtype == np.float32
    assert _levels_that_differ(got, want) == [0, 0, 0]
    # and the plain version, which the CPU takes, is the same function
    plain = TP.normalize_flip_cutout(imgs, None, None, MEAN, STD).numpy()
    assert _levels_that_differ(plain, want) == [0, 0, 0]


@pytest.mark.parametrize("c", [0, 1, 2])
def test_warp_kernel_constants_are_the_float64_product_rounded_once(c):
    """The warp kernel's constants stay JAX's ``float(mean[c]) * 255.0``
    (``fedmlp_tpu/ops/pallas_warp.py``), so that the kernel and its plain
    version keep the warp kernel's bits."""
    m, s = W.norm_constants(MEAN, STD)
    assert np.float32(m[c]) == np.float32(float(MEAN[c]) * 255.0)
    assert np.float32(s[c]) == np.float32(float(STD[c]) * 255.0)
    # the f32 product differs where the JAX package's normalize differs
    m32, s32 = W.norm_constants_f32(MEAN, STD)
    assert np.float32(m32[c]) == np.float32(MEAN[c]) * np.float32(255.0)
    assert np.float32(s32[c]) == np.float32(STD[c]) * np.float32(255.0)
    assert (s32[c] != s[c]) == (c == 1)
