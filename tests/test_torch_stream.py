"""Host streaming in the port (``data.host_stream``, ``data.stream_window``;
fedmlp_tpu_torch/parallel/streaming.py, the Trainer's ``RoundStream``, the
streamed harvest): streamed rounds against resident ones and windowed
against unwindowed, bit for bit, on the per-client loop and the lockstep
engine; the window bound; RSCFed's teacher and RoFL's ``cstate`` across
windows; one windowed FedMLP run against the JAX ``Trainer``'s; the
refusals; the CLI on a shard.

smallcnn at 32 px, 4 clients, float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig, RoFLConfig
from fedmlp_tpu_torch.data.datasets import make_synthetic_dataset, save_packed_dataset
from fedmlp_tpu_torch.train import Trainer, UnportedConfigError
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B, C, IMG = 8, 4, 32


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """128 training images (non-iid: client sizes differ, so ragged batches
    and padding steps occur) and 16 test images, the training images also
    as a packed images.npy."""
    d = tmp_path_factory.mktemp("shard")
    train = make_synthetic_dataset(128, C, IMG, seed=11)
    test = make_synthetic_dataset(16, C, IMG, seed=12)
    save_packed_dataset(train, str(d / "train"))
    save_packed_dataset(test, str(d / "test"))
    return train, test, str(d / "train" / "images.npy"), str(d)


def _cfg(stream=False, window=0, **kw):
    base = dict(algorithm="fedmlp", model="smallcnn", batch_size=B, base_lr=1e-3,
                n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=31,
                p_pos=0.0, compute_dtype="float32", output_dir="",
                fedmlp=FedMLPConfig(rounds_stage1=1, clean_threshold=0.2,
                                    noise_threshold=0.2))
    base.update(kw)
    return Config(**base, data=DataConfig(name="synthetic", n_classes=C, image_size=IMG,
                                          host_stream=stream, stream_window=window))


def _run(shard, rounds=2, stream=False, window=0, **kw):
    train, test, npy, _ = shard
    tr = Trainer(_cfg(stream, window, **kw), train_ds=train, test_ds=test, device="cpu",
                 images_npy=npy if stream else None)
    assert (tr.fd.images is None) == stream and (tr.loader is not None) == stream
    losses = [tr.run_round(r).client_losses for r in range(rounds)]
    return tr, losses


def _assert_same(a, b):
    """Bit-equal losses, global state dict and server state."""
    (ta, la), (tb, lb) = a, b
    assert la == lb
    assert ta.global_vars.keys() == tb.global_vars.keys()
    for n, v in ta.global_vars.items():
        assert torch.equal(v, tb.global_vars[n]), n
    for n, v in ta.server_state.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, tb.server_state[n], err_msg=n)


_RESIDENT = {}


@pytest.mark.parametrize("window", [0, 2, 3])
@pytest.mark.parametrize("engine", ["off", "on"])
def test_streamed_rounds_equal_the_resident_rounds(shard, engine, window):
    """FedMLP, a stage-1 round that harvests and a stage-2 round (two more
    harvests), streamed from the shard at once (W=0) or in windows (W=2;
    W=3, whose last window is ragged), on the per-client loop ('off') and
    the lockstep engine ('on'): the same bits as the resident run, tags,
    τ and prototypes included. The loop's window holds W steps of one
    client, the lockstep engine's W steps of all K, and at most two are
    held at once."""
    if engine not in _RESIDENT:
        _RESIDENT[engine] = _run(shard, batched_global=engine)
    tr, losses = _run(shard, stream=True, window=window, batched_global=engine)
    _assert_same((tr, losses), _RESIDENT[engine])
    assert int((tr.server_state["tags"] > 0).sum()) > 0
    S = int(np.ceil(tr.fd.valid.sum(1).max().item() / B))
    K = tr.n_clients
    bound = S * K * B if window == 0 else 2 * window * B * (K if engine == "on" else 1)
    assert 0 < tr.stream_peak_rows <= bound
    if window:  # two windows were held at once
        assert tr.stream_peak_rows > window * B * (K if engine == "on" else 1)


@pytest.mark.parametrize("algorithm", ["rscfed", "rofl"])
def test_teacher_and_client_state_cross_windows(shard, algorithm):
    """RSCFed's EMA teacher and RoFL's per-client state (``cstate``, its
    harvest streamed too) on the per-client loop: windowed (W=2) equals
    unwindowed, which equals resident."""
    kw = dict(algorithm=algorithm, rofl=RoFLConfig(T_pl=1))
    runs = [_run(shard, **kw), _run(shard, stream=True, **kw),
            _run(shard, stream=True, window=2, **kw)]
    for other in runs[1:]:
        _assert_same(other, runs[0])
    if algorithm == "rscfed":
        for n, v in runs[0][0]._rscfed_teacher.items():
            assert torch.equal(runs[2][0]._rscfed_teacher[n], v), n


def test_windowed_fedmlp_matches_the_jax_trainer(shard):
    """The port's FedMLP with ``host_stream`` and ``stream_window=2`` against
    the JAX ``Trainer``'s on the same shard (``images_npy=``): a stage-1
    round that harvests and a stage-2 round, 'normonly' views, the JAX
    initial weights copied in. The tolerances of the FedMLP parity test
    (tests/test_torch_fedmlp_slice.py): losses within rtol 1e-3, τ and
    prototypes within atol 1e-3, the tags equal."""
    train, test, npy, _ = shard
    kw = dict(algorithm="fedmlp", model="smallcnn", batch_size=B, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=7,
              p_pos=0.0, compute_dtype="float32", output_dir="")
    fed = dict(rounds_stage1=1, clean_threshold=0.2, noise_threshold=0.2)
    data = dict(name="synthetic", n_classes=C, image_size=IMG, augment_backend="normonly",
                host_stream=True, stream_window=2)
    jt = JTrainer(JConfig(**kw, fedmlp=JFed(**fed), data=JData(**data)), train_ds=train,
                  test_ds=test, use_mesh=False, images_npy=npy)
    tt = Trainer(Config(**kw, fedmlp=FedMLPConfig(**fed), data=DataConfig(**data)),
                 train_ds=train, test_ds=test, device="cpu", images_npy=npy)
    assert jt.fd.images is None and tt.fd.images is None
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-3)
        for key in ("tao", "proto"):
            np.testing.assert_allclose(tt.server_state[key], jt.server_state[key],
                                       rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tt.server_state["tags"], jt.server_state["tags"])
    assert int((tt.server_state["tags"] > 0).sum()) > 0


@pytest.mark.parametrize("kw,fields", [
    (dict(stream=True, window=2, pre_augment=16), ["data.stream_window", "pre_augment"]),
    (dict(window=2), ["data.stream_window", "data.host_stream"]),
    (dict(stream=True, window=2, hoist_augment=1), ["data.stream_window", "hoist_augment"]),
    (dict(stream=True, window=-1), ["data.stream_window"]),
], ids=lambda v: "-".join(v) if isinstance(v, list) else None)
def test_refusals_name_their_fields(shard, kw, fields):
    kw = dict(kw)
    stream, window = kw.pop("stream", False), kw.pop("window")
    train, test, npy, _ = shard
    with pytest.raises(UnportedConfigError) as e:
        Trainer(_cfg(stream, window, **kw), train_ds=train, test_ds=test, device="cpu",
                images_npy=npy)
    for f in fields:
        assert f"{f}=" in str(e.value), (f, str(e.value))


def test_host_stream_without_a_shard_raises(shard, tmp_path):
    train, test, _, _ = shard
    for npy in (None, str(tmp_path / "missing.npy")):
        with pytest.raises(UnportedConfigError, match="requires a packed images.npy"):
            Trainer(_cfg(True), train_ds=train, test_ds=test, device="cpu", images_npy=npy)
    wrong = str(tmp_path / "wrong.npy")
    np.save(wrong, np.zeros((4, IMG, IMG, 3), np.uint8))
    with pytest.raises(ValueError, match="holds images"):
        Trainer(_cfg(True), train_ds=train, test_ds=test, device="cpu", images_npy=wrong)


def test_cli_streams_a_windowed_round_from_the_shard(shard, tmp_path):
    """``--host_stream 1 --stream_window 2 --data_root <shard>`` on the CPU:
    the train split stays a memory map, the rounds run and log."""
    _, _, _, root = shard
    TCli.main(["--exp", "FedAVG", "--dataset", "synthetic", "--model", "smallcnn",
               "--device", "cpu", "--n_classes", str(C), "--image_size", str(IMG),
               "--n_clients", "4", "--batch_size", str(B), "--rounds", "2",
               "--eval_every", "2", "--compute_dtype", "float32", "--data_root", root,
               "--host_stream", "1", "--stream_window", "2",
               "--output_dir", str(tmp_path)])
    logs = tmp_path / "FedAVG_synthetic" / "logs"
    assert "round 1 metrics" in (logs / "logs.txt").read_text()
    assert (logs / "metrics.jsonl").read_text().count('"step": 1') > 0
