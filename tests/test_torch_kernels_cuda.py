"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only torch and the port, so that it runs on a machine
without JAX; there the repository's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Without a card every test skips.
"""

import pytest
import torch

from fedmlp_tpu_torch.ops import warp as W

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _batch(dev, B, S, seed, degrees=10.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    ang, tx, ty, flip = W.weak_params(B, S, S, g, dev, degrees=degrees)
    ang[0], tx[0], ty[0] = 0.0, 0.0, 0.0  # the identity
    flip[1] = True
    params = W.paeth_shift_params(torch.deg2rad(ang), tx, ty, S, S).contiguous()
    return imgs, params, flip


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,degrees", [(8, 224, 10.0), (3, 97, 10.0), (4, 64, 40.0)])
def test_fused_warp_kernel_matches_plain_version(card, B, S, degrees):
    """atol 1e-4 on the normalized scale; in practice bitwise, since the
    kernel rounds every product and sum on its own in the plain version's
    order. The 40° case has shear slopes far beyond the weak range, where
    the kernel must stay exact (it computes each row's shift, no tap
    bound)."""
    imgs, params, flip = _batch(card, B, S, seed=S, degrees=degrees)
    W.reset_launch_counts()
    got = W.fused_warp_normalize(imgs, params, flip, MEAN, STD)
    want = W.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD)
    torch.cuda.synchronize()
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 1
    assert got.shape == (B, 3, S, S) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_fused_warp_kernel_rejects_strided_input(card):
    """A CUDA batch gets the kernel or an exception, never the plain version."""
    imgs, params, flip = _batch(card, 2, 32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        W.fused_warp_normalize(imgs.transpose(1, 2), params, flip, MEAN, STD)
