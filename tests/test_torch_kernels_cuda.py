"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only torch and the port, so that it runs on a machine
without JAX; there the repository's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Without a card every test skips.
"""

import pytest
import torch

from fedmlp_tpu_torch.ops import dw_pallas as D
from fedmlp_tpu_torch.ops import fused_conv_bn as CB
from fedmlp_tpu_torch.ops import pallas_ops as P
from fedmlp_tpu_torch.ops import warp as W

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _batch(dev, B, S, seed, degrees=10.0, beyond=False):
    """Images 0 and 1: the identity and a forced flip; with ``beyond``,
    images 2 and 3 translated past the plane's edge along x and y."""
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    ang, tx, ty, flip = W.weak_params(B, S, S, g, dev, degrees=degrees)
    ang[0], tx[0], ty[0] = 0.0, 0.0, 0.0  # the identity
    flip[1] = True
    if beyond:
        tx[2] = S + 40.0
        ty[3] = -(S + 40.0)
    params = W.paeth_shift_params(torch.deg2rad(ang), tx, ty, S, S).contiguous()
    return imgs, params, flip


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,degrees", [(8, 224, 10.0), (3, 97, 10.0), (4, 64, 40.0),
                                          (32, 224, 40.0)])
def test_fused_warp_kernel_matches_plain_version(card, B, S, degrees):
    """atol 1e-4 on the normalized scale; in practice bitwise, since the
    kernel rounds every product and sum on its own in the plain version's
    order. The 40° cases have shear slopes far beyond the weak range, where
    the kernel must stay exact (it computes each row's shift, no tap
    bound): their source bands outgrow the staged planes, and two images
    are translated past the plane (an empty band). S = 97 stages byte by
    byte and stores a ragged run at the end of each row."""
    imgs, params, flip = _batch(card, B, S, seed=S, degrees=degrees,
                                beyond=degrees > 10.0)
    W.reset_launch_counts()
    got = W.fused_warp_normalize(imgs, params, flip, MEAN, STD)
    want = W.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD)
    torch.cuda.synchronize()
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 1
    assert got.shape == (B, 3, S, S) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N", [640, 2560, 3600])
def test_fused_warp_kernel_over_a_whole_round_of_images(card, N):
    """One launch over every view image of a hoisted round (N = S·K·B =
    2560 at the flagship's stage 2) or of a lockstep or stacked step's view
    (N = K·B = 640), equal bit for bit to the same images in launches of
    32: the kernel works image by image. At N = 3600 the output passes 2^31
    bytes, so every byte offset must be 64-bit."""
    imgs, params, flip = _batch(card, N, 224, seed=N)
    W.reset_launch_counts()
    got = W.fused_warp_normalize(imgs, params, flip, MEAN, STD)
    torch.cuda.synchronize()
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 1
    assert got.shape == (N, 3, 224, 224) and got.numel() * 4 > (2**31 if N > 3567 else 0)
    for c in range(0, N, 32):
        part = W.fused_warp_normalize(imgs[c:c + 32], params[c:c + 32], flip[c:c + 32],
                                      MEAN, STD)
        assert torch.equal(part, got[c:c + 32]), c
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 1 + -(-N // 32)


@pytest.mark.cuda
def test_fused_warp_kernel_rejects_strided_input(card):
    """A CUDA batch gets the kernel or an exception, never the plain version."""
    imgs, params, flip = _batch(card, 2, 32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        W.fused_warp_normalize(imgs.transpose(1, 2), params, flip, MEAN, STD)


def _dw_operands(dev, B, C, H, k, stride, pads, dtype, seed=0):
    """x, the strided cotangent and the filter of one depthwise layer's
    backward."""
    g = torch.Generator(device=dev).manual_seed(seed)
    (pt, pb), _ = pads
    Ho = (H + pt + pb - k) // stride + 1
    x = torch.randn((B, C, H, H), generator=g, device=dev).to(dtype)
    dy = torch.randn((B, C, Ho, Ho), generator=g, device=dev).to(dtype)
    w = torch.randn((C, 1, k, k), generator=g, device=dev).to(dtype)
    return x, dy, w


_DW_CASES = [
    # B, C, H, k, stride, pads
    (3, 5, 9, 5, 1, ((1, 3), (4, 0))),      # odd size, uneven pad split
    (2, 7, 7, 5, 1, ((2, 2), (2, 2))),      # more padding than data
    (4, 24, 30, 3, 2, ((0, 1), (0, 1))),    # stride 2, even size: pads (0, 1)
    (2, 6, 113, 5, 2, ((2, 2), (2, 2))),    # odd, a plane larger than a tile
    (8, 16, 56, 3, 1, ((1, 1), (1, 1))),
]

# the 16 depthwise layers of EfficientNet-B0 at 224 px: C, H, k, stride
_B0_LAYERS = [(32, 112, 3, 1), (96, 112, 3, 2), (144, 56, 3, 1), (144, 56, 5, 2),
              (240, 28, 5, 1), (240, 28, 3, 2), (480, 14, 3, 1), (480, 14, 3, 1),
              (480, 14, 5, 1), (672, 14, 5, 1), (672, 14, 5, 1), (672, 14, 5, 2),
              (1152, 7, 5, 1), (1152, 7, 5, 1), (1152, 7, 5, 1), (1152, 7, 3, 1)]


def _check_dw_kernels(x, dy, w, k, stride, pads, dtype):
    """``dw_dgrad`` and ``dw_wgrad`` against their plain versions.
    dx: 1e-5 in float32 (FMA against separately rounded products and sums),
    one bf16 ulp (2^-7 relative) in bf16. dw: 1e-4 of the largest |dw|
    (float32 sums in another order); a repeat gives the same bits."""
    hw = tuple(x.shape[2:])
    D.reset_launch_counts()
    dx = D.dw_dgrad(dy, w, stride, pads, hw)
    dw = D.dw_wgrad(x, dy, k, stride, pads)
    dw_again = D.dw_wgrad(x, dy, k, stride, pads)
    torch.cuda.synchronize()
    assert D.LAUNCH_COUNTS == {"dw_dgrad": 1, "dw_wgrad": 2}
    dx_ref = D.dw_dgrad_ref(dy, w, stride, pads, hw)
    dw_ref = D.dw_wgrad_ref(x, dy, k, stride, pads)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    err = (dx.float() - dx_ref.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= dx_ref.float().abs() * 2.0 ** -7 + 1e-6).all())
    assert float((dw - dw_ref).abs().max()) <= 1e-4 * float(dw_ref.abs().max())
    assert torch.equal(dw, dw_again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,k,stride,pads", _DW_CASES)
def test_dw_kernels_match_plain_versions(card, B, C, H, k, stride, pads, dtype):
    """``dw_dgrad`` and ``dw_wgrad`` against their plain versions on the
    strided cotangent (tolerances in ``_check_dw_kernels``)."""
    x, dy, w = _dw_operands(card, B, C, H, k, stride, pads, dtype)
    _check_dw_kernels(x, dy, w, k, stride, pads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,k,stride", _B0_LAYERS)
def test_dw_kernels_at_the_b0_layers(card, C, H, k, stride):
    """Both kernels at each EfficientNet-B0 layer's shape, B=2, bf16: every
    launch plan the model runs (row tiles and whole-plane groups)."""
    from fedmlp_tpu_torch.models.layers import same_pads

    pads = (same_pads(H, k, stride), same_pads(H, k, stride))
    x, dy, w = _dw_operands(card, 2, C, H, k, stride, pads, torch.bfloat16, seed=C + H)
    _check_dw_kernels(x, dy, w, k, stride, pads, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,k,stride", _B0_LAYERS)
def test_dw_kernels_at_the_b0_layers_at_2b(card, C, H, k, stride, dtype):
    """Both kernels at each EfficientNet-B0 layer's shape at B=64, the batch
    of FedMLP's one-forward stage 1 (``view_concat='on'``), in bf16 and
    float32: the launch plans that pick their splits and items from B."""
    from fedmlp_tpu_torch.models.layers import same_pads

    pads = (same_pads(H, k, stride), same_pads(H, k, stride))
    x, dy, w = _dw_operands(card, 64, C, H, k, stride, pads, dtype, seed=C * H)
    _check_dw_kernels(x, dy, w, k, stride, pads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,k,stride", [(37, 7, 5, 1), (19, 14, 3, 2)])
def test_dw_kernels_with_a_ragged_last_group(card, C, H, k, stride, dtype):
    """B*C planes not a multiple of the block's group of whole planes, and C
    not a multiple of dw's channel group: the last group is partial and the
    runs of planes start off a 16-byte boundary."""
    from fedmlp_tpu_torch.models.layers import same_pads

    pads = (same_pads(H, k, stride), same_pads(H, k, stride))
    Ho = (H + sum(pads[0]) - k) // stride + 1
    elt = 2 if dtype == torch.bfloat16 else 4
    dplan = D.dgrad_plan(3, C, H, H, Ho, Ho, k, stride, pads[0][0], pads[1][0], elt)
    wplan = D.wgrad_plan(3, C, H, H, Ho, Ho, k, stride, pads[0][0], pads[1][0], elt)
    assert not dplan.rows and (3 * C) % dplan.group and C % wplan.group
    x, dy, w = _dw_operands(card, 3, C, H, k, stride, pads, dtype, seed=C)
    _check_dw_kernels(x, dy, w, k, stride, pads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,H", [(3, 1, 14), (5, 2, 14), (3, 2, 15)])
def test_dw_conv_pallas_backward_matches_conv2d_on_the_card(card, k, stride, H):
    """The autograd function on CUDA tensors, under bf16 autocast, against
    ``F.conv2d``'s own backward (cuDNN, TF32 off) in float32 on the
    bf16-rounded operands: gradients within bf16's rounding (rtol 2^-6 of
    the largest value)."""
    from fedmlp_tpu_torch.models.layers import same_pads
    from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(1)
    C = 12
    m = DepthwisePallas(C, k, stride).to(card)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=card))
    x = torch.randn((4, C, H, H), generator=g, device=card, requires_grad=True)
    pads = (same_pads(H, k, stride), same_pads(H, k, stride))
    D.reset_launch_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = m(x, pads)
    assert y.dtype == torch.bfloat16
    ct = torch.randn(y.shape, generator=g, device=card).bfloat16()
    y.backward(ct)
    assert D.LAUNCH_COUNTS == {"dw_dgrad": 1, "dw_wgrad": 1}

    x2 = x.detach().bfloat16().float().requires_grad_(True)
    w2 = m.weight.detach().bfloat16().float().requires_grad_(True)
    (pt, pb), (pl, pr) = pads
    y2 = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x2, (pl, pr, pt, pb)), w2, None, stride, 0, 1, C)
    y2.backward(ct.float())
    for got, want in ((x.grad, x2.grad), (m.weight.grad, w2.grad)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 2.0 ** -6 * float(want.abs().max())


@pytest.mark.cuda
def test_dw_kernels_reject_what_they_do_not_take(card):
    """A CUDA tensor gets the kernel or an exception, never the plain
    version."""
    x = torch.zeros((2, 4, 8, 8), device=card)
    w = torch.zeros((4, 1, 3, 3), device=card)
    pads = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        D.dw_dgrad(x.transpose(2, 3), w, 1, pads, (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        D.dw_wgrad(x, x.transpose(2, 3), 3, 1, pads)
    w7 = torch.zeros((4, 1, 7, 7), device=card)
    with pytest.raises(ValueError, match="k in"):
        D.dw_dgrad(x, w7, 1, ((3, 3), (3, 3)), (8, 8))
    with pytest.raises(ValueError, match="stride in"):
        D.dw_wgrad(x, torch.zeros((2, 4, 3, 3), device=card), 3, 3, pads)
    with pytest.raises(ValueError, match="match the cotangent's type and device"):
        D.dw_dgrad(x, w.cpu(), 1, pads, (8, 8))


@pytest.mark.cuda
def test_dw_kernels_reject_a_misaligned_view(card):
    """A contiguous view that starts off a 16-byte boundary raises: the
    kernels' vector loads need the boundary, and no slower path or plain
    version takes the call instead."""
    base = torch.zeros(2 * 4 * 8 * 8 + 1, device=card, dtype=torch.bfloat16)
    x = base[1:].view(2, 4, 8, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.zeros((4, 1, 3, 3), device=card, dtype=torch.bfloat16)
    ok = torch.zeros((2, 4, 8, 8), device=card, dtype=torch.bfloat16)
    pads = ((1, 1), (1, 1))
    D.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        D.dw_dgrad(x, w, 1, pads, (8, 8))
    with pytest.raises(ValueError, match="16-byte boundary"):
        D.dw_wgrad(x, ok, 3, 1, pads)
    with pytest.raises(ValueError, match="16-byte boundary"):
        D.dw_wgrad(ok, x, 3, 1, pads)
    assert D.LAUNCH_COUNTS == {"dw_dgrad": 0, "dw_wgrad": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [3, 2])
@pytest.mark.parametrize("B,C,H,Wd", [(4, 3, 224, 224), (1, 1, 37, 53), (3, 3, 50, 19),
                                     (2, 3, 7, 300)])
def test_hshift_kernel_matches_plain_version(card, B, C, H, Wd, axis):
    """``hshift_rows`` at ragged shapes (H, W not multiples of 32, W above
    the block's 256 threads, B = 1, C = 1), on both axes: fractional shifts
    up to the plane's size, an integer shift (exact copy), a shift beyond the
    plane (zeros). atol 1e-4 on the 0..255 scale; in practice bitwise, since
    the kernel rounds every product and sum in the plain version's order."""
    g = torch.Generator(device=card).manual_seed(H * Wd)
    x = torch.rand((B, C, H, Wd), generator=g, device=card) * 255.0
    n = H if axis == 3 else Wd
    length = Wd if axis == 3 else H
    shifts = (torch.rand((B, n), generator=g, device=card) * 2.0 - 1.0) * length
    shifts[0, 0] = 3.0
    shifts[0, 1] = float(length + 5)
    shifts[0, 2] = -1e9
    W.reset_launch_counts()
    got = W.hshift_rows(x, shifts, axis=axis)
    want = W.hshift_rows_ref(x, shifts, axis=axis)
    torch.cuda.synchronize()
    assert W.LAUNCH_COUNTS["hshift_rows"] == 1
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4
    line = (lambda t, i: t[0, :, i, :]) if axis == 3 else (lambda t, i: t[0, :, :, i])
    assert torch.equal(line(got, 0)[..., :length - 3], line(x, 0)[..., 3:])
    assert not line(got, 1).any() and not line(got, 2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [3, 2])
def test_hshift_kernel_at_a_pre_augment_chunk(card, axis):
    """One pass over a 256-image chunk at 224 px (``pre_augment=256``: the
    strong view's passes), shifts up to the RandAugment pool's 60 px and an
    integer row, against the plain version: atol 1e-4 on the 0..255 scale."""
    g = torch.Generator(device=card).manual_seed(256 + axis)
    x = torch.rand((256, 3, 224, 224), generator=g, device=card) * 255.0
    shifts = (torch.rand((256, 224), generator=g, device=card) * 2.0 - 1.0) * 60.0
    shifts[0] = 7.0
    W.reset_launch_counts()
    got = W.hshift_rows(x, shifts, axis=axis)
    want = W.hshift_rows_ref(x, shifts, axis=axis)
    torch.cuda.synchronize()
    assert W.LAUNCH_COUNTS["hshift_rows"] == 1
    assert float((got - want).abs().max()) <= 1e-4
    moved = got[0] if axis == 3 else got[0].transpose(1, 2)
    src = x[0] if axis == 3 else x[0].transpose(1, 2)
    assert torch.equal(moved[..., :-7], src[..., 7:])


@pytest.mark.cuda
def test_paeth_affine_on_the_card_is_three_launches_and_matches_the_cpu(card):
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.rand((5, 3, 61, 45), generator=g, device=card) * 255.0
    ang, tx, ty, _ = W.weak_params(5, 61, 45, g, card)
    W.reset_launch_counts()
    got = W.paeth_affine(x, torch.deg2rad(ang), tx, ty)
    assert W.LAUNCH_COUNTS["hshift_rows"] == 3
    want = W.paeth_affine(x.cpu(), torch.deg2rad(ang).cpu(), tx.cpu(), ty.cpu())
    # 2e-3 on the 0..255 scale: the card's and the CPU's sin and tan
    assert float((got.cpu() - want).abs().max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Wd", [(8, 224, 224), (1, 33, 47), (3, 5, 300)])
def test_normalize_flip_cutout_kernel_matches_plain_version(card, B, H, Wd):
    """Mixed flips, a box inside, a zero box, a box cut by the border, and
    None for either operand. Equal bits: every output value is an entry of
    the kernel's gray-level table, which holds the plain version's own
    subtraction and correctly rounded division for each of the 256 levels.
    W = 47 runs one pixel a thread, the others four."""
    g = torch.Generator(device=card).manual_seed(B + H)
    imgs = torch.randint(0, 256, (B, H, Wd, 3), generator=g, device=card, dtype=torch.uint8)
    flips = (torch.arange(B, device=card) % 2).to(torch.int32)
    boxes = torch.zeros((B, 4), dtype=torch.int32, device=card)
    boxes[0] = torch.tensor([1, 2, min(17, Wd), min(18, H)])
    if B > 2:
        boxes[2] = torch.tensor([Wd - 3, H - 2, Wd + 13, H + 14])
    out = torch.empty((B, H, Wd, 3), dtype=torch.float32, device=card)
    assert P.normalize_flip_cutout_plan(imgs, out, MEAN, STD)[0] == (Wd % 4 == 0)
    P.reset_launch_counts()
    for f, b in ((flips, boxes), (None, boxes), (flips, None), (None, None)):
        got = P.normalize_flip_cutout(imgs, f, b, MEAN, STD)
        want = P.normalize_flip_cutout_ref(imgs, f, b, MEAN, STD)
        torch.cuda.synchronize()
        assert got.shape == (B, H, Wd, 3) and got.dtype == torch.float32
        assert torch.equal(got, want)
    assert P.LAUNCH_COUNTS["normalize_flip_cutout"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 128])
def test_normalize_flip_cutout_kernel_at_the_evaluation_chunks(card, B):
    """The evaluation's chunk (64 test images) and its default batch size
    (128), 224 px, neither flips nor boxes, through ``eval_batch``: equal
    bits."""
    from fedmlp_tpu_torch.ops import augment as A

    g = torch.Generator(device=card).manual_seed(B)
    imgs = torch.randint(0, 256, (B, 224, 224, 3), generator=g, device=card,
                         dtype=torch.uint8)
    P.reset_launch_counts()
    got = A.eval_batch(imgs, MEAN, STD)
    want = P.normalize_flip_cutout_ref(imgs, None, None, MEAN, STD).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert P.LAUNCH_COUNTS["normalize_flip_cutout"] == 1
    assert got.shape == (B, 3, 224, 224) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Wd", [47, 48])
def test_normalize_flip_cutout_kernel_on_an_unaligned_batch_view(card, Wd):
    """``imgs[1:]`` of a batch whose image is not a multiple of 16 bytes,
    and a W % 4 == 0 batch one byte into its buffer: both run one pixel a
    thread and give the plain version's bits."""
    g = torch.Generator(device=card).manual_seed(Wd)
    H = 13
    if Wd == 47:
        imgs = torch.randint(0, 256, (4, H, Wd, 3), generator=g, device=card,
                             dtype=torch.uint8)[1:]
    else:
        flat = torch.randint(0, 256, (3 * H * Wd * 3 + 16,), generator=g, device=card,
                             dtype=torch.uint8)
        imgs = flat[1:1 + 3 * H * Wd * 3].view(3, H, Wd, 3)
    assert imgs.is_contiguous() and imgs.data_ptr() % 16 != 0
    out = torch.empty(imgs.shape, dtype=torch.float32, device=card)
    assert not P.normalize_flip_cutout_plan(imgs, out, MEAN, STD)[0]
    flips = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    boxes = torch.tensor([[3, 2, 20, 9], [0, 0, 0, 0], [40, 10, 60, 20]],
                         dtype=torch.int32, device=card)
    got = P.normalize_flip_cutout(imgs, flips, boxes, MEAN, STD)
    want = P.normalize_flip_cutout_ref(imgs, flips, boxes, MEAN, STD)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """The f32 unit in the last place of |v| (v > 0)."""
    return torch.pow(2.0, torch.floor(torch.log2(v)) - 23.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(32, 8), (1, 1), (7, 5), (65536, 8), (100003, 3)])
def test_bce_masked_sum_kernel_matches_plain_version(card, B, C):
    """Forward within 1e-5 relative of the plain version in float64 (f32
    sums in another order), finite with logits at ±30, equal bits on a
    repeat (one block or many: partial sums are added in index order).
    The gradient kernel, with a cotangent g = 0.37 ≠ 1, against
    ``bce_with_logits_masked_grad_ref``: within 2 ulps of |g|·max(pw, 1),
    since both round every product in the same order but the card's expf
    in the kernel and torch's sigmoid may differ in the last bit of p.
    pos_weight [C], mask [B, C] and [B, 1] read in place by stride. Each
    call is one launch of its kernel: the plain versions never run."""
    g = torch.Generator(device=card).manual_seed(B)
    x = (torch.randn((B, C), generator=g, device=card) * 4.0)
    x[0, 0] = 30.0
    x[-1, -1] = -30.0
    x.requires_grad_(True)
    y = (torch.rand((B, C), generator=g, device=card) < 0.4).float()
    pw = torch.rand((C,), generator=g, device=card) * 3.5 + 0.5
    cot = torch.tensor(0.37, device=card)
    for mask in ((torch.rand((B, C), generator=g, device=card) < 0.7).float(),
                 (torch.rand((B, 1), generator=g, device=card) < 0.7).float()):
        P.reset_launch_counts()
        got = P.bce_with_logits_masked_sum(x, y, pw, mask)
        again = P.bce_with_logits_masked_sum(x, y, pw, mask)
        want = P.bce_with_logits_masked_sum_ref(x.detach().double(), y.double(),
                                                pw.double(), mask.double())
        torch.cuda.synchronize()
        assert torch.isfinite(got) and torch.equal(got.detach(), again.detach())
        assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want)) + 1e-6
        (dx,) = torch.autograd.grad(got, x, cot)
        dx_ref = P.bce_with_logits_masked_grad_ref(cot, x.detach(), y, pw, mask)
        torch.cuda.synchronize()
        assert P.LAUNCH_COUNTS == {"normalize_flip_cutout": 0,
                                   "bce_with_logits_masked_sum": 2,
                                   "bce_with_logits_masked_grad": 1}
        tol = 2.0 * _ulp(cot.abs() * torch.clamp(pw, min=1.0)).expand(B, C)
        assert torch.isfinite(dx).all()
        assert bool(((dx - dx_ref).abs() <= tol).all())


@pytest.mark.cuda
def test_bce_masked_sum_forward_and_backward_are_two_device_operations(card):
    """At the training shape [32, 8]: one kernel forward (no fill before
    it), one kernel backward (no elementwise chain), by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((32, 8), generator=g, device=card).requires_grad_(True)
    y = (torch.rand((32, 8), generator=g, device=card) < 0.4).float()
    pw = torch.rand((8,), generator=g, device=card) + 0.5
    mask = (torch.rand((32, 8), generator=g, device=card) < 0.7).float()
    cot = torch.tensor(0.25, device=card)
    torch.autograd.grad(P.bce_with_logits_masked_sum(x, y, pw, mask), x, cot)  # build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(P.bce_with_logits_masked_sum(x, y, pw, mask), x, cot)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    assert len(names) == 2, names


@pytest.mark.cuda
def test_new_kernels_reject_what_they_do_not_take(card):
    """A CUDA tensor gets the kernel or an exception, never the plain
    version."""
    x = torch.zeros((2, 3, 8, 8), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        W.hshift_rows(x.transpose(2, 3), torch.zeros((2, 8), device=card))
    with pytest.raises(ValueError, match="different devices"):
        W.hshift_rows(x, torch.zeros((2, 8)))
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        P.normalize_flip_cutout(imgs.transpose(1, 2), None, None, MEAN, STD)
    with pytest.raises(ValueError, match="flips on"):
        P.normalize_flip_cutout(imgs, torch.zeros(2, dtype=torch.int32), None, MEAN, STD)
    z = torch.zeros((4, 6), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        P.bce_with_logits_masked_sum(z.t().contiguous().t(), z, torch.ones(6, device=card), z)
    with pytest.raises(ValueError, match="f32 on"):
        P.bce_with_logits_masked_sum(z, z, torch.ones(6), z)
    g = torch.ones((), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        P.bce_with_logits_masked_grad(g, z.t().contiguous().t(), z,
                                      torch.ones(6, device=card), z)
    with pytest.raises(ValueError, match="f32 scalar"):
        P.bce_with_logits_masked_grad(torch.ones(()), z, z, torch.ones(6, device=card), z)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["swish", "none"])
@pytest.mark.parametrize("M,Ci,Co,dtype", [
    (1000, 16, 96, torch.bfloat16), (63, 24, 144, torch.float32),
    (1, 3, 50, torch.bfloat16), (6272, 80, 480, torch.bfloat16),
    (4097, 80, 200, torch.float32), (100352, 24, 144, torch.bfloat16),
    # bf16, the tensor-core route: Ci not a multiple of 16 (3: rows of x
    # not 16-byte units, no cp.async), Co not a multiple of 8, Ci = 256,
    # Co = 480 (slabs of 160 columns), M = 1, 63, 4097, 100352
    (63, 24, 97, torch.bfloat16), (4097, 40, 50, torch.bfloat16),
    (1000, 3, 97, torch.bfloat16), (4097, 256, 480, torch.bfloat16),
    (1, 256, 96, torch.bfloat16), (100352, 40, 480, torch.bfloat16)])
def test_conv_bn_kernels_match_plain_versions(card, M, Ci, Co, dtype, act):
    """Ragged M (not a multiple of the 64-row tile), Co not a multiple of the
    block's columns, both activations, each kernel called twice; the checks
    and tolerances of chip_smoke.py's kernel phase (``_conv_bn_case``): y
    within one ulp (bf16: beyond the reordered-sum bound), sums within 1e-5
    relative, out within one bf16 ulp or four f32 ulps beyond what the two
    sets of statistics make of it, equal bits on a repeat."""
    import chip_smoke

    CB.reset_launch_counts()
    res = chip_smoke._conv_bn_case(card, M, Ci, Co, dtype, act)
    assert CB.LAUNCH_COUNTS == {"conv1x1_bn_stats": 2, "conv1x1_bn_act_2pass": 2}
    assert res["ok"], repr(res)


@pytest.mark.cuda
def test_conv_bn_kernels_reject_what_they_do_not_take(card):
    """A CUDA tensor gets the kernel or an exception, never the plain
    version."""
    x = torch.zeros((64, 16), device=card)
    w = torch.zeros((16, 8), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        CB.conv1x1_bn_stats(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="above the kernel"):
        CB.conv1x1_bn_stats(torch.zeros((4, 300), device=card),
                            torch.zeros((300, 8), device=card))
    with pytest.raises(ValueError, match="w on"):
        CB.conv1x1_bn_stats(x, w.cpu())
    with pytest.raises(ValueError, match="scale"):
        CB.conv1x1_bn_act_2pass(x, w, torch.ones(7, device=card), torch.zeros(8, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("M,Ci,Co", [(40000, 24, 97), (40001, 16, 96), (6271, 80, 480),
                                     (130, 256, 480)])
def test_conv_bn_bf16_kernels_write_nothing_past_m(card, M, Ci, Co):
    """y and out land in views of buffers with sentinel rows past M. Whole-row
    tiles (M ≥ 264 tiles of 64 and Co ≤ 160: one block owns all Co
    columns, so a full tile leaves in one bulk store) with a ragged last
    tile, Co odd or a multiple of 8; column slabs (Co = 480, or few tiles):
    the rows past M keep their bits, and the rows before equal what the
    wrappers return."""
    g = torch.Generator(device=card)
    g.manual_seed(M)
    x = torch.randn((M, Ci), generator=g, device=card).to(torch.bfloat16)
    w = torch.randn((Ci, Co), generator=g, device=card).to(torch.bfloat16)
    scale = torch.rand((Co,), generator=g, device=card) + 0.5
    bias = torch.randn((Co,), generator=g, device=card)
    y_buf = torch.full((M + 64, Co), -7.0, dtype=torch.bfloat16, device=card)
    out_buf = torch.full((M + 64, Co), -7.0, dtype=torch.bfloat16, device=card)
    s_into, ss_into = CB.conv1x1_bn_stats_into(x, w, y_buf[:M])
    mean_into, var_into = CB.conv1x1_bn_act_2pass_into(x, w, scale, bias, out_buf[:M])
    torch.cuda.synchronize()
    assert bool((y_buf[M:] == -7.0).all()) and bool((out_buf[M:] == -7.0).all())
    y, s, ss = CB.conv1x1_bn_stats(x, w)
    out, mean, var = CB.conv1x1_bn_act_2pass(x, w, scale, bias)
    assert torch.equal(y_buf[:M], y) and torch.equal(out_buf[:M], out)
    assert torch.equal(s_into, s) and torch.equal(ss_into, ss)
    assert torch.equal(mean_into, mean) and torch.equal(var_into, var)


# ----------------------------------------------------------------------
# The lockstep and stacked engines on the card (float32 with TF32 off, as
# the Trainer sets it)
# ----------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_lockstep_round_matches_the_loop_on_the_card(card):
    """One FedMLP stage-1 round, K=4, smallcnn at 32 px, float32, 'normonly'
    views: the lockstep engine's client losses within 1e-4 relative of the
    per-client loop's (its frozen-global forward runs at K·B = 32 images
    against 8, which may pick another cuDNN algorithm)."""
    from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig
    from fedmlp_tpu_torch.train import Trainer

    losses = {}
    for mode in ("off", "on"):
        cfg = Config(algorithm="fedmlp", model="smallcnn", batch_size=8, base_lr=1e-3,
                     n_clients=4, seed=7, compute_dtype="float32", output_dir="",
                     fedmlp=FedMLPConfig(rounds_stage1=2), batched_global=mode,
                     data=DataConfig(name="synthetic", n_classes=4, image_size=32,
                                     synthetic_train_size=96, synthetic_test_size=16,
                                     augment_backend="normonly"))
        tr = Trainer(cfg, device=card)
        assert tr.engine == ("lockstep" if mode == "on" else "mapped")
        losses[mode] = torch.tensor(tr.run_round(0).client_losses)
    rel = ((losses["on"] - losses["off"]).abs() / losses["off"].abs()).max()
    assert float(rel) <= 1e-4, (losses, float(rel))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_stacked_forward_matches_per_client_forwards_on_the_card(card, no_tf32, dtype,
                                                                  tol):
    """EfficientNet-B0 at 64 px, 3 clients of different weights, B=4, eval
    and train mode (bf16 under autocast, as the Trainer runs it): each
    client's stacked logits within ``tol`` of the largest magnitude of its
    own forward's (float32 1e-3, ``chip_smoke.py``'s ``ZOO_REL_TOL``; bf16
    5e-2: 8 bits of mantissa through 16 blocks in two orders)."""
    from fedmlp_tpu_torch.models import build_model, init_model
    from fedmlp_tpu_torch.models.stacked import stacked_apply

    models = [init_model(build_model("efficient_b0", 5), seed).to(card) for seed in range(3)]
    sv = {n: torch.stack([m.state_dict()[n] for m in models])
          for n in models[0].state_dict()}
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((3, 4, 3, 64, 64), generator=g, device=card)
    cast = torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16)
    for train in (False, True):
        with torch.no_grad(), cast:
            (_, logits), _ = stacked_apply(models[0], sv, x, train=train)
            for k, m in enumerate(models):
                want = m.train(train)(x[k])[1].float()
                err = (logits[k].float() - want).abs().max() / want.abs().max()
                assert float(err) <= tol, (train, k, float(err))
