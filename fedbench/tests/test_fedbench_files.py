"""Every cell's files are found by name, and a new cell, mix or metric reader
is new files and entries alone."""

import json
import shutil

import pytest

from fedbench import cell as C
from fedbench import harness

BENCH = json.loads((C.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(work):
    cell = C.load_cell(work["name"])
    assert cell.limits, "a cell has the limits of its correctness check"
    assert C.reference_model(cell).FEATURE_DIM > 0
    assert C.flop_counter(cell).forward_flops(cell.config["image_size"],
                                              cell.config["n_classes"]) > 0
    assert cell.config["source"] == {c["name"]: c for c in BENCH["configs"]}[
        work["config"]]["source"]
    for key in {c["name"]: c for c in BENCH["configs"]}[work["config"]]["reduced"]:
        assert key in cell.config and key in cell.config["published"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = C.load_file_module(harness.reader_path(metric["name"], C.ROOT))
    assert callable(mod.read)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    moved = e2e[metric["moves"]]
    assert metric["moves"] != "setup_s"
    for cell in metric.get("workloads", cells):
        assert cell in cells and cell in moved.get("workloads", cells)


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(work):
    from fedbench.run import cell_metrics

    e2e = [n for n, _u in cell_metrics(BENCH, work["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(BENCH, work["name"], "per_layer")


def test_a_split_metric_is_read_by_its_base_reader(tmp_path):
    assert harness.reader_path("mfu.b0", C.ROOT) == harness.reader_path("mfu", C.ROOT)
    (tmp_path / harness.METRICS_DIR).mkdir(parents=True)
    own = tmp_path / harness.METRICS_DIR / "mfu.b0.py"
    own.write_text("def read(rec):\n    return 1.0\n")
    assert harness.reader_path("mfu.b0", tmp_path) == own


def test_a_new_mix_and_reader_are_new_files_only(tmp_path):
    """A throwaway mix, a cell on it and a reader, written under TMPDIR beside
    copies of the files that exist: the loader finds them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(C.ROOT / "fedbench", root / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    mix = dict(json.loads((root / "fedbench/traffic/fedmlp_s1.json").read_text()),
               setup_rounds=1)
    (root / "fedbench/traffic/throwaway.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "r18-throwaway", "config": "resnet18-cxr14",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "ops_total", "unit": "ops", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_img_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "fedbench/metrics/ops_total.py").write_text(
        "def read(rec):\n    return float(len(rec['ops'])) or None\n")
    cell = C.load_cell("r18-throwaway", root=root)
    assert cell.traffic["setup_rounds"] == 1 and cell.config["model"] == "resnet18"
    rec = {"ops": [("k", 0, 1, True)] * 3}
    assert harness.read_metrics(rec, [("ops_total", "ops")], root) == {
        "ops_total": {"value": 3.0, "unit": "ops"}}
    assert harness.read_metrics({"ops": []}, [("ops_total", "ops")], root) == {}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        C.load_cell("no-such-cell")


def test_the_seed_reaches_the_program_whole_below_2_32():
    assert C.program_seed(2**31 + 5) == 2**31 + 5
    assert C.program_seed(2**32 + 5) == 5
    cfg = C.build_config(C.load_cell("effb0-fedmlp-s1"), 2**31 + 5)
    assert cfg.seed == 2**31 + 5 and cfg.algorithm == "fedmlp"
    assert cfg.batched_global == "auto" and cfg.client_stacking == "auto"  # defaults


@pytest.mark.parametrize("entry", ["run", "calibrate"])
def test_without_a_card_nothing_runs(entry, monkeypatch, capsys):
    """The cells run on the card only: the run and the calibration exit 2
    and print no result where there is none."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TRITON_CACHE_DIR", "USE_FLAX", "OMP_NUM_THREADS"):  # restored after
        monkeypatch.setenv(var, "")
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    main = importlib.import_module(f"fedbench.{entry}").main
    args = ["--workload", "r18-fedmlp-s1"] + (
        ["--seed", "1", "--seconds", "1"] if entry == "run" else ["--seeds", "1"])
    assert main(args) == 2
    assert capsys.readouterr().out == ""
