"""The metric readers and the trace reduction on small synthetic traces."""

import pytest

from fedbench import cell as C
from fedbench import trace

READ = {n: C.load_file_module(C.ROOT / "fedbench" / "metrics" / f"{n}.py").read
        for n in ("mfu", "device_idle_pct", "device_ops_per_step", "device_ms_per_step",
                  "warp_roofline", "algo_share_pct", "train_img_per_s")}
MS = 1_000_000  # ns


def _rec():
    """A 100 ms round: a local pass over [0, 80) ms of 4 steps, then an
    aggregation; device ops (name, start, end, in a local pass), two of them
    overlapping."""
    ops = [("conv", 0, 20 * MS, True), ("conv", 10 * MS, 30 * MS, True),
           ("fused_warp_kernel<8>", 40 * MS, 41 * MS, True),
           ("fused_warp_kernel<8>", 50 * MS, 51 * MS, True),
           ("reduce", 85 * MS, 90 * MS, False)]
    return {"round_ns": (0, 100 * MS), "local_ns": [(0, 80 * MS)], "steps": 4,
            "how": "launch", "ops": ops, "peak_flops": 1e12, "peak_bytes_per_s": 1e9,
            "untraced": {"flops": 2e11, "seconds": 1.0, "median_round_s": 0.074, "local_s": 0.75,
                         "images": 512},
            "warp": {"launches": 2, "images": 2, "side": 10}}


def test_idle_is_the_union_not_the_sum():
    # busy: [0, 30) ∪ [40, 41) ∪ [50, 51) ∪ [85, 90) = 37 ms; the sum would be 47;
    # over the untraced rounds' median wall of 74 ms, not the traced 100 ms
    assert READ["device_idle_pct"](_rec()) == pytest.approx(50.0)
    assert trace.busy_window_s(_rec()) == pytest.approx((0.037, 0.1))


def test_local_pass_readers():
    r = _rec()
    assert READ["device_ops_per_step"](r) == 4 / 4
    assert READ["device_ms_per_step"](r) == pytest.approx(32 / 4)  # union, in ms
    assert READ["algo_share_pct"](r) == pytest.approx(25.0)  # untraced: 0.75 of 1 s
    assert READ["mfu"](r) == pytest.approx(20.0)
    assert READ["train_img_per_s"](r) == pytest.approx(512.0)  # untraced images over seconds


def test_warp_roofline():
    # 2 views of 10 x 10 x 3 u8 and 37 B of parameters in, f32 out: 3074 B over
    # 1e9 B/s, in 2 ms of kernel time
    assert READ["warp_roofline"](_rec()) == pytest.approx(100 * 3.074e-6 / 2e-3)


def test_readers_read_nothing_where_nothing_is():
    r = dict(_rec(), ops=[("conv", 0, MS, True)], how=None, untraced=None)
    assert READ["warp_roofline"](r) is None  # no kernel: silent, never 0
    assert READ["device_ops_per_step"](r) is None
    assert READ["device_ms_per_step"](r) is None
    assert READ["mfu"](r) is None
    assert READ["device_idle_pct"](r) is None and READ["algo_share_pct"](r) is None
    assert READ["train_img_per_s"](r) is None
    r = dict(_rec(), warp=dict(_rec()["warp"], launches=3))
    assert READ["warp_roofline"](r) is None  # the trace misses a launch


def test_record_places_ops_by_launch_then_by_annotation():
    host = [(trace.ROUND, 0, 100, 0), (trace.LOCAL, 10, 50, 0),
            ("cudaLaunchKernel", 20, 21, 7), ("cudaLaunchKernel", 60, 61, 8)]
    device = [("k1", 30, 40, 7), ("k2", 65, 70, 8)]
    rec = trace.record(device, [], host, steps=2)
    assert rec["how"] == "launch" and [op[3] for op in rec["ops"]] == [True, False]
    rec = trace.record([("k1", 30, 40, 0), ("k2", 65, 70, 0)], [(trace.LOCAL, 25, 45)],
                       host, steps=2)
    assert rec["how"] == "annotation" and [op[3] for op in rec["ops"]] == [True, False]
    with pytest.raises(ValueError):
        trace.record(device, [], host[1:], steps=2)


def test_breakdown_names_what_the_host_did_in_each_gap():
    host = [(trace.ROUND, 0, 100, 0), ("aten::copy_", 40, 60, 0), ("outer", 0, 100, 0)]
    rec = {"round_ns": (0, 100), "ops": [("a", 0, 40, True), ("b", 60, 90, False)]}
    out = trace.breakdown(rec, host)
    assert out["device_ops"] == [["a", 40e-9], ["b", 30e-9]]
    assert out["idle_gaps"] == [["aten::copy_", 20e-9], ["outer", 10e-9]]
