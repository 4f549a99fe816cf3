"""The last small modules of the port against the JAX package: the loss
helpers ``masked_class_mean``, ``la_kd`` and ``pos_weight_from_counts``
(ops/losses.py), ``trace_round`` (utils/profiling.py),
the tensorboardX passthrough of ``MetricWriter`` (utils/logging.py), and
``tsne_visual``, ``roc_print`` and ``fn_tn_loss_separation``
(eval/visual.py)."""

import json

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.eval import visual as JV
from fedmlp_tpu.ops import losses as JL
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.eval import visual as TV
from fedmlp_tpu_torch.ops import losses as TL
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.utils.logging import MetricWriter
from fedmlp_tpu_torch.utils.profiling import trace_round
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

matplotlib.use("Agg")


def _inputs(seed=0, n=12, c=5):
    rng = np.random.RandomState(seed)
    probs = rng.uniform(0.01, 0.99, (n, c)).astype(np.float32)
    targets = (rng.rand(n, c) < 0.4).astype(np.float32)
    soft = rng.uniform(0, 1, (n, c)).astype(np.float32)
    active = rng.rand(c) < 0.5
    active[0], active[1] = True, False
    return probs, targets, soft, active


@pytest.mark.parametrize("batch_size", [None, 16])
def test_loss_helpers_match_jax(batch_size):
    """The configured batch size (16 > 12 rows, a ragged batch) as the
    denominator where given, the leading size otherwise; an empty mask
    divides by one class."""
    probs, targets, soft, active = _inputs()
    t = {n: torch.from_numpy(a) for n, a in
         (("p", probs), ("y", targets), ("s", soft), ("a", active), ("n", ~active))}
    loss = (probs - soft) ** 2
    for mask in (active, ~active, np.zeros_like(active)):
        np.testing.assert_allclose(
            TL.masked_class_mean(torch.from_numpy(loss), torch.from_numpy(mask),
                                 batch_size).numpy(),
            np.asarray(JL.masked_class_mean(jnp.asarray(loss), jnp.asarray(mask),
                                            batch_size)), rtol=1e-6)
    for w in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            TL.la_kd(t["p"], t["y"], t["s"], w, t["a"], t["n"], batch_size).numpy(),
            np.asarray(JL.la_kd(probs, targets, soft, w, active, ~active, batch_size)),
            rtol=1e-6)
    counts = np.array([0.0, 1.0, 7.0, 30.0, 2.5])
    got = TL.pos_weight_from_counts(30, counts)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, JL.pos_weight_from_counts(30, counts), rtol=1e-6)


def test_trace_round_writes_a_chrome_trace_only_when_asked(tmp_path):
    with trace_round(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    with trace_round("") as prof:
        pass
    assert prof is None and not list(tmp_path.iterdir())
    out = tmp_path / "trace"
    with trace_round(str(out)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (path,) = list(out.glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_metric_writer_passes_scalars_to_tensorboardx(tmp_path):
    pytest.importorskip("tensorboardX")
    w = MetricWriter(str(tmp_path))
    w.add_scalar("loss", 0.5, 3)
    w.close()
    (rec,) = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert (rec["tag"], rec["value"], rec["step"]) == ("loss", 0.5, 3)
    (events,) = list(tmp_path.glob("events.out.tfevents.*"))
    assert b"loss" in events.read_bytes()


def test_roc_print_draws_the_jax_curves(tmp_path, monkeypatch):
    """The per-class curves and AUC labels drawn by both packages' figure
    functions (``plt.plot`` recorded), and the PNG written."""
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(3)
    y = (rng.rand(40, 4) < 0.3).astype(np.float32)
    y[:, 3] = 0  # a class without positives
    probs = rng.rand(40, 4).astype(np.float32)
    drawn = []
    real = plt.plot

    def record(*args, **kw):
        drawn[-1].append((np.asarray(args[0], float), np.asarray(args[1], float),
                          kw.get("label")))
        return real(*args, **kw)

    monkeypatch.setattr(plt, "plot", record)
    for fn, name in ((JV.roc_print, "jax.png"), (TV.roc_print, "port.png")):
        drawn.append([])
        assert fn(y, probs, str(tmp_path / name), class_names=list("abcd")) == \
            str(tmp_path / name)
        assert (tmp_path / name).stat().st_size > 0
    want, got = drawn
    assert len(got) == len(want) == 5
    for (wx, wy, wl), (gx, gy, gl) in zip(want, got):
        assert gl == wl
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert [c[2] for c in TV.roc_curves(y, probs)][:3] == pytest.approx(
        [float(lbl.split("AUC=")[1][:-1]) for _, _, lbl in got[:3]], abs=5e-4)


def test_fn_tn_loss_separation_matches_jax():
    """Both Trainers on the same data and the JAX initial weights (through
    weights.py): the per-missing-class false-negative and true-negative
    losses within 1e-5 relative; under host_stream the port raises."""
    kw = dict(algorithm="fedavg", model="smallcnn", batch_size=8, n_clients=4,
              rounds_warmup=1, eval_every=100, seed=5, p_pos=0.5,
              compute_dtype="float32", output_dir="")
    data = dict(name="synthetic", n_classes=4, image_size=32, synthetic_train_size=64,
                synthetic_test_size=16, augment_backend="normonly")
    jt = JTrainer(JConfig(**kw, data=JData(**data)), use_mesh=False)
    tt = TTrainer(TConfig(**kw, data=TData(**data)), device="cpu")
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    n_fn = 0
    for client in (0, 2):
        want = JV.fn_tn_loss_separation(jt, client)
        got = TV.fn_tn_loss_separation(tt, client)
        assert got.keys() == want.keys() and want
        for c in want:
            for key in ("fn_loss", "tn_loss"):
                np.testing.assert_allclose(got[c][key], want[c][key], rtol=1e-5)
            n_fn += not np.isnan(want[c]["fn_loss"])
    assert n_fn > 0
    tt.fd.images = None  # as host_stream leaves it
    with pytest.raises(ValueError, match="host_stream"):
        TV.fn_tn_loss_separation(tt, 0)


def test_tsne_visual_writes_a_png(tmp_path):
    pytest.importorskip("sklearn")
    rng = np.random.RandomState(0)
    feats = np.concatenate([rng.randn(8, 6), rng.randn(8, 6) + 4])
    path = TV.tsne_visual(feats, np.repeat([0, 1], 8), 3, "proto", str(tmp_path))
    assert path == str(tmp_path / "round3_proto.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
