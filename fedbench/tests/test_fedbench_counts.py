"""The yardsticks: FLOP counters against hand counts, B1's bytes."""

import math

from fedbench import cell as C
from fedbench import harness

FLOPS = C.ROOT / "fedbench" / "flops"
METRICS = C.ROOT / "fedbench" / "metrics"


def test_b0_block_by_hand():
    """block1_0 at 112 px: expand 16→96 1x1 at 112², depthwise 3x3/2 at 56²,
    squeeze-excite 96→4→96, project 96→24 at 56²."""
    b0 = C.load_file_module(FLOPS / "efficient_b0.py")
    hand = 112 * 112 * 16 * 96 + 56 * 56 * 96 * 9 + 96 * 4 * 2 + 56 * 56 * 96 * 24
    assert b0.block_macs(112, 16, 24, 6, 3, 2) == hand
    assert math.isclose(b0.forward_flops(224, 1000) / 2, 0.39e9, rel_tol=0.02)  # Table 1


def test_r18_block_by_hand():
    """layer2_0 at 56 px: 3x3/2 64→128 and 3x3 128→128 at 28², projection
    1x1/2 64→128."""
    r18 = C.load_file_module(FLOPS / "resnet18.py")
    hand = 28 * 28 * 128 * 64 * 9 + 28 * 28 * 128 * 128 * 9 + 28 * 28 * 128 * 64
    assert r18.block_macs(56, 64, 128, 2) == hand
    assert math.isclose(r18.forward_flops(224, 1000) / 2, 1.8e9, rel_tol=0.02)  # Table 1


def test_warp_bytes_at_batch_32():
    w = C.load_file_module(METRICS / "warp_roofline.py")
    assert round(w.view_bytes(32, 224) / 1e6, 2) == 24.09


def test_a_round_counts_eight_forwards_an_image():
    cell = C.load_cell("effb0-fedmlp-s1")
    F = C.flop_counter(cell).forward_flops(224, 8)
    assert harness.round_flops(cell) == 8 * F * 2048
    assert C.local_steps_per_round(cell) == 64 and C.images_per_round(cell) == 2048
