"""The Swin-B cell (``swinb-fedmlp-s1``) on the CPU: its plain reference
against the program at the published widths, a sound tiny run and a broken
one against the limits, the FLOP and parameter counts against the paper's
Table 1, and the window attention's roofline arithmetic."""

import time

import pytest
import torch

from fedbench import cell as C
from fedbench import harness
from fedbench.tests.helpers import SEED, tiny_cell
from fedbench.tests.test_fedbench_imports import FORBIDDEN, _loaded
from fedbench.tests.test_fedbench_reference import _half_batch

NAME = "swinb-fedmlp-s1"


def _readers():
    return [C.load_file_module(harness.reader_path(n, C.ROOT))
            for n in ("attn_roofline.swin", "attn_share_pct.swin")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_reference_forward_is_the_programs_at_published_widths(train):
    from fedmlp_tpu_torch.models import build_model

    ref = C.reference_model(C.load_cell(NAME))
    w = ref.init_weights(8, torch.Generator().manual_seed(3), "cpu")
    model = build_model("swin_b", 8, image_size=64)
    model.load_state_dict(w)  # strict: the same names and shapes
    model.train(train)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        f1, l1 = model(x, generator=torch.Generator().manual_seed(5))
        f2, l2 = ref.forward(w, x, train, torch.Generator().manual_seed(5))
    # float32 both, sums in another order over 24 blocks
    assert (l1 - l2).abs().max().item() <= 1e-4 * l2.abs().max().item()
    assert (f1 - f2).abs().max().item() <= 1e-4 * f2.abs().max().item()


def _run(patch=None) -> dict:
    """The cell at the harness tests' tiny size, one step a client a round."""
    torch.set_num_threads(2)
    cell = tiny_cell(NAME)
    cell.config["train_images_per_client"] = cell.config["batch_size"]
    return harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter(), patch=patch)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}


def test_the_half_batch_fault_is_not_correct():
    out = _run(_half_batch)
    assert not out["correct"], out["checks"]


def test_flops_are_table_1s():
    flops = C.flop_counter(C.load_cell(NAME))
    assert abs(flops.forward_flops(224, 1000) / 2 / 15.4e9 - 1) < 0.02
    # stage 1's block by hand: 56² tokens of 128 channels, 64 windows of 49
    linears = 56 * 56 * 128 * (3 * 128 + 128 + 2 * 4 * 128)
    products = 64 * 2 * 49 * 49 * 128
    assert flops.block_macs(56, 128) == linears + products == 655_900_672


def test_parameters_are_table_1s():
    from fedmlp_tpu_torch.models import build_model

    n = sum(p.numel() for p in build_model("swin_b", 1000).parameters())
    assert abs(n / 88e6 - 1) < 0.005
    assert n == C.load_cell(NAME).config["parameters_1000_classes"]


def test_attention_roofline_of_one_stage_1_call():
    roof, _share = _readers()
    rows = 32 * 64 * 4  # a batch of 32: 64 windows of 49 tokens, 4 heads of 32
    assert roof.geometry() == (49, 32, 2)
    # forward: q·kᵀ and p·v, 2 · 49² · 32 FLOPs each a row; backward four more
    assert roof.call_flops(rows, 49, 32, False) == rows * 4 * 49 * 49 * 32 == 2_517_630_976
    assert roof.call_flops(rows, 49, 32, True) == 3 * 2_517_630_976
    # bytes: q, k, v, o in bf16 (49 · 32 · 2 each) forward; backward q, k, v,
    # o, dO in and dq, dk, dv out, and the float32 log-sum-exp both ways
    block = 49 * 32 * 2
    assert roof.call_bytes(rows, 49, 32, 2, False) == rows * 4 * block == 102_760_448
    assert roof.call_bytes(rows, 49, 32, 2, True) == rows * (12 * block + 2 * 4 * 49)
    counts = {"calls": 1, "rows_grad": 0, "rows_nograd": rows}
    least = roof.least_seconds(counts, (49, 32, 2), 989e12, 3.35e12)
    assert least == pytest.approx(102_760_448 / 3.35e12)  # bound by bytes


def test_the_attention_readers(monkeypatch):
    """The readers on a made-up traced round: a forward launch a counted
    call or nothing; the share of the local passes' busy time."""
    from fedmlp_tpu_torch.utils import profiling as P

    roof, share = _readers()
    monkeypatch.setattr(P, "HISTORY", [{"profiled": False, "counters": {}}, {
        "profiled": True, "counters": {P.ATTN_CALLS_GRAD: 1, P.ATTN_ROWS_GRAD: 8192,
                                       P.ATTN_CALLS_NOGRAD: 1, P.ATTN_ROWS_NOGRAD: 8192}}])
    ops = [("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", 0, 100_000, True),
           ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", 100_000, 200_000, True),
           ("fmha_cutlassB_bf16_aligned_64x64_k32_sm80", 200_000, 400_000, True),
           ("gemm", 400_000, 1_000_000, True), ("copy", 1_000_000, 1_100_000, False)]
    rec = {"ops": ops, "how": "launch", "peak_flops": 989e12, "peak_bytes_per_s": 3.35e12}
    want = roof.least_seconds({"calls": 2, "rows_grad": 8192, "rows_nograd": 8192},
                              (49, 32, 2), 989e12, 3.35e12) / 400e-6 * 100
    assert roof.read(rec) == pytest.approx(want)
    assert 0 < want < 100
    assert share.read(rec) == pytest.approx(40.0)
    assert roof.read(dict(rec, ops=ops[1:])) is None  # a launch the counter did not count
    assert share.read(dict(rec, ops=ops[3:])) is None
    assert roof.read(dict(rec, ops=ops[3:])) is None


def test_the_reference_and_readers_load_nothing_of_the_program():
    mods = _loaded("import fedbench.reference.models.swin_b\n"
                   "from fedbench import cell, harness\n"
                   "for n in ('attn_roofline', 'attn_share_pct'):\n"
                   "    cell.load_file_module(harness.reader_path(n, cell.ROOT))")
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN + ("fedmlp_tpu_torch",)] == []

