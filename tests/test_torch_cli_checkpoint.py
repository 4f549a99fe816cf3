"""The port's CLI and checkpoint/resume (fedmlp_tpu_torch/cli.py,
utils/checkpoint.py, utils/logging.py, train.py::check_ported) against the
JAX package's CLI, and on their own on the CPU."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fedmlp_tpu import cli as JCli
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig, MeshConfig
from fedmlp_tpu_torch.ops.depthwise import DepthwiseDense, DepthwiseReroute, DepthwiseTaps
from fedmlp_tpu_torch.train import Trainer, UnportedConfigError
from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _jax_parser_actions():
    """The JAX CLI builds its parser inside ``args_parser``: capture it."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["parser"] = self
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = spy
    try:
        JCli.args_parser([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]._actions


def _flags(actions):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else tuple(a.choices))
            for a in actions if a.dest != "help"}


def test_parser_has_the_jax_cli_flags_and_defaults():
    """Same option strings, defaults, types and choices, flag for flag; the
    port adds ``--device`` and nothing else."""
    want = _flags(_jax_parser_actions())
    got = _flags(TCli.build_parser()._actions)
    assert got.pop("device") == (("--device",), "cuda", str, ("cuda", "cpu"))
    assert got == want
    assert TCli.EXP_ALIASES == JCli.EXP_ALIASES


def _cfg_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("argv", [
    ["--exp", "FeMLP", "--dataset", "ICH", "--rounds_FedMLP_stage1", "7"],
    ["--exp", "FedAVG", "--dataset", "ChestXray14"],
    ["--exp", "FedAVG+FixMatch", "--dataset", "synthetic"],
    ["--exp", "FedNoRo", "--dataset", "synthetic", "--rounds_FedNoRo_warmup", "1",
     "--begin", "0", "--end", "2", "--a", "0.6"],
    ["--exp", "FedAVG", "--dataset", "ICH", "--data_root", "/data/ich",
     "--host_stream", "1", "--stream_window", "4"],
    ["--exp", "RoFL", "--dataset", "synthetic", "--n_classes", "6", "--n_clients", "3",
     "--image_size", "48", "--dw_backend", "pallas", "--stage2_distill", "1",
     "--forget_rate", "0.3", "--t_w", "5", "--rounds_FedIRM_sup", "2", "--begin", "3",
     "--rounds_CBAFed_warmup", "9", "--base_lr", "1e-2", "--exp_tag", "t",
     "--augment_backend", "normonly", "--synthetic_train_size", "99"],
])
def test_config_from_args_equals_jax(argv):
    """Every ``Config`` field (sub-configs included) equals the JAX CLI's
    for the same argument list."""
    want = JCli.config_from_args(JCli.args_parser(argv))
    got = TCli.config_from_args(TCli.args_parser(argv))
    assert _cfg_dict(got) == dataclasses.asdict(want)


def test_stream_window_without_host_stream_exits():
    a = TCli.args_parser(["--exp", "FedAVG", "--dataset", "ICH", "--data_root", "/d",
                          "--stream_window", "4"])
    with pytest.raises(SystemExit):
        TCli.config_from_args(a)
    with pytest.raises(SystemExit, match="unknown --exp"):
        TCli.config_from_args(TCli.args_parser(["--exp", "nope"]))


_SMALL = ["--dataset", "synthetic", "--model", "smallcnn", "--device", "cpu",
          "--batch_size", "16", "--image_size", "32", "--base_lr", "1e-3",
          "--synthetic_train_size", "128", "--synthetic_test_size", "32",
          "--compute_dtype", "float32"]


@pytest.mark.parametrize("extra,message", [
    (["--exp", "FedAVG", "--model", "Resnet18", "--client_stacking", "on"],
     "client_stacking='on' is refused: model 'Resnet18' has no stacked forward"),
    (["--exp", "FedAVG", "--data_root", "/data/x", "--host_stream", "1",
      "--stream_window", "2", "--hoist_augment", "1"],
     "data.stream_window=2 with hoist_augment=1 is refused"),
    (["--exp", "FedAVG+FixMatch", "--batched_global", "on"],
     "batched_global='on' is refused: algorithm 'fixmatch' does not need the global"),
    (["--exp", "CBAFed", "--client_stacking", "on"],
     "client_stacking='on' is refused: algorithm 'cbafed' has no stacked loss"),
])
def test_cli_exits_with_a_message_for_what_is_not_ported(tmp_path, extra, message):
    argv = _SMALL + ["--output_dir", str(tmp_path)] + extra
    with pytest.raises(SystemExit) as e:
        TCli.main(argv)
    assert message in str(e.value)
    assert not os.listdir(tmp_path)  # nothing was started


def _cfg(**kw):
    base = dict(
        algorithm="fedavg", model="smallcnn", batch_size=16, base_lr=1e-3,
        n_clients=4, local_ep=1, rounds_warmup=4, eval_every=100, seed=5,
        data=DataConfig(name="synthetic", n_classes=4, image_size=32,
                        synthetic_train_size=128, synthetic_test_size=32),
        compute_dtype="float32", output_dir="",
    )
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("field,kw", [
    ("client_stacking", dict(client_stacking="on", model="resnet18")),
    # host streaming runs (tests/test_torch_stream.py); refused without a shard
    ("data.host_stream", dict(data=DataConfig(name="synthetic", host_stream=True))),
    ("pre_augment", dict(pre_augment=16, client_stacking="on")),
    ("view_concat", dict(algorithm="fedmlp", view_concat="on", client_stacking="on")),
    ("param_dtype", dict(param_dtype="bfloat16")),
    ("view_precat", dict(view_precat="sometimes")),
    ("model", dict(model="resnet9")),
    ("batched_global", dict(batched_global="on")),
    # a window runs with host_stream only
    ("data.stream_window", dict(data=DataConfig(name="synthetic", stream_window=4))),
    # a mesh larger than the world (one process here); the other refusals
    # of a mesh beside it (tests/test_torch_mesh.py runs the mesh)
    pytest.param("mesh.data_axis", dict(mesh=MeshConfig(data_axis=2)), id="mesh-kw9"),
    ("mesh.client_axis", dict(mesh=MeshConfig(client_axis=1))),
    # a batch the data axis does not divide runs unsharded in a world of 2
    # (tests/test_torch_mesh.py); in this world of 1 the mesh is refused
    pytest.param("mesh.data_axis", dict(batch_size=15, mesh=MeshConfig(data_axis=2)),
                 id="batch_size-kw11"),
    ("hoist_augment", dict(hoist_augment=1, mesh=MeshConfig(data_axis=2))),
])
def test_unported_config_values_raise_naming_the_field(field, kw):
    """No knob is accepted and ignored: a ``Config`` value the port has no
    implementation for raises a typed error at ``Trainer`` construction."""
    with pytest.raises(UnportedConfigError, match=rf"(^|; ){field}="):
        Trainer(_cfg(**kw), device="cpu")


def _b0_cfg(**kw):
    return _cfg(model="efficient_b0", batch_size=2, n_clients=2,
                data=DataConfig(name="synthetic", n_classes=3, image_size=32,
                                synthetic_train_size=8, synthetic_test_size=4), **kw)


_DW = {"taps": DepthwiseTaps, "dense": DepthwiseDense, "reroute": DepthwiseReroute}
_STAGES_01 = {"block0_0", "block1_0", "block1_1"}


@pytest.mark.parametrize("field,kw", [
    ("dw_backend", dict(dw_backend="taps")),
    ("dw_backend", dict(dw_backend="dense")),
    ("dw_backend", dict(dw_backend="reroute")),
    ("weight_stream", dict(weight_stream=1, compute_dtype="bfloat16")),
    ("remat", dict(remat=1)),
    ("remat_stages", dict(remat_stages="0,1")),
])
def test_ported_knobs_reach_the_model_or_the_round(field, kw):
    """Each knob that the port refused until the model-side slice now
    builds a ``Trainer`` (the per-client loop on EfficientNet-B0) and lands
    where the JAX package puts it: the depthwise modules, the per-block
    rematerialization of the working and frozen twins, or the round's
    weight type."""
    t = Trainer(_b0_cfg(**kw), device="cpu")
    assert t.engine == "mapped"
    twin = t._frozen_twin()
    if field == "dw_backend":
        for m in (t.model, twin):
            assert isinstance(m.block0_0.dw_conv, _DW[kw["dw_backend"]])
            # 'dense' stops at 192 depthwise channels: block2_1 has 240
            assert isinstance(m.block2_1.dw_conv, torch.nn.Conv2d) == (
                kw["dw_backend"] == "dense")
    elif field == "weight_stream":
        assert t.weight_stream_dtype == torch.bfloat16
        assert Trainer(_b0_cfg(weight_stream=1), device="cpu").weight_stream_dtype is None
    else:
        want = set(t.model.block_names) if field == "remat" else _STAGES_01
        assert t.model.remat_names == want and twin.remat_names == want
        assert t.weight_stream_dtype is None


def test_remat_stages_parse_as_the_jax_trainer():
    """A comma list of stage indices, blanks skipped; a non-integer raises
    as the JAX ``Trainer``'s ``int()`` does."""
    assert Trainer(_b0_cfg(remat_stages="1, ,0"), device="cpu").model.remat_names == \
        _STAGES_01
    with pytest.raises(ValueError, match="invalid literal for int"):
        Trainer(_b0_cfg(remat_stages="0,early"), device="cpu")


@pytest.mark.parametrize("extra,reached", [
    (["--model", "Resnet18", "--remat", "1"], lambda m: m.remat),
    (["--model", "efficient_b0", "--dw_backend", "taps"],
     lambda m: isinstance(m.block3_2.dw_conv, DepthwiseTaps)),
])
def test_cli_model_knobs_reach_the_trainer(tmp_path, extra, reached):
    """``--remat`` and ``--dw_backend`` from the command line to the model
    that the ``Trainer`` builds (the flags the port used to refuse)."""
    a = TCli.args_parser(_SMALL + ["--exp", "FedAVG", "--output_dir", str(tmp_path),
                                   "--n_clients", "2"] + extra)
    t = Trainer(TCli.config_from_args(a), device="cpu")
    assert reached(t.model)


def test_auto_and_empty_values_resolve_and_dw_backend_reaches_the_model():
    from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas

    cfg = _cfg(model="efficient_b0", dw_backend="pallas", client_stacking="auto",
               view_concat="auto", pre_augment=-1, batch_size=2, n_clients=2,
               data=DataConfig(name="synthetic", n_classes=3, image_size=32,
                               synthetic_train_size=8, synthetic_test_size=4))
    t = Trainer(cfg, device="cpu")
    assert isinstance(t.model.block0_0.dw_conv, DepthwisePallas)
    t = Trainer(cfg.replace(dw_backend=""), device="cpu")
    assert isinstance(t.model.block0_0.dw_conv, torch.nn.Conv2d)
    # and the knob is not handed to a model that has no depthwise convs
    Trainer(_cfg(dw_backend="pallas"), device="cpu")


def test_fedmlp_resume_preserves_stage2_state(tmp_path):
    """Resume mid-stage-2 restores tags, τ and prototypes: the resumed
    round 3 equals the original's, bit for bit on the CPU."""
    def mk():
        return Trainer(_cfg(
            algorithm="fedmlp", seed=9,
            fedmlp=FedMLPConfig(rounds_stage1=2, clean_threshold=0.1,
                                noise_threshold=0.1)), device="cpu")

    t1 = mk()
    for r in range(3):  # into stage 2 (tags exist)
        t1.run_round(r)
    assert (t1.server_state["tags"] > 0).any()
    f = save_checkpoint(str(tmp_path), t1, 2)
    assert os.path.basename(f) == "ckpt_2.pkl"
    saved = {k: np.array(v, copy=True) for k, v in t1.server_state.items()}
    t1.run_round(3)

    t2 = mk()
    assert load_checkpoint(f, t2) == 3
    for k, v in saved.items():
        np.testing.assert_array_equal(t2.server_state[k], v, err_msg=k)
        assert t2.server_state[k].dtype == v.dtype
    assert t2.iter_num == t1.iter_num - 2 and len(t2.history) == 3
    t2.run_round(3)
    for k in ("tags", "tao", "proto"):
        np.testing.assert_array_equal(t2.server_state[k], t1.server_state[k], err_msg=k)
    assert t2.history[-1].client_losses == t1.history[-1].client_losses


def test_fedavg_resume_equals_straight_run_bitwise(tmp_path):
    """2 + 2 rounds through save/load equal 4 rounds straight, bit for bit
    on the CPU, with the warp's random draws on (the generator's state is
    part of the checkpoint)."""
    t1 = Trainer(_cfg(), device="cpu")
    t1.run_round(0)
    t1.run_round(1)
    f = save_checkpoint(str(tmp_path), t1, 1)
    t1.run_round(2)
    t1.run_round(3)

    t2 = Trainer(_cfg(), device="cpu")
    assert load_checkpoint(f, t2) == 2
    assert all(v.device.type == "cpu" for v in t2.global_vars.values())
    t2.run_round(2)
    t2.run_round(3)
    assert set(t1.global_vars) == set(t2.global_vars)
    for n, v in t1.global_vars.items():
        assert torch.equal(v, t2.global_vars[n]), n
    assert [r.client_losses for r in t2.history] == [r.client_losses for r in t1.history]


class _PersistentAlgo:
    """An algorithm module that keeps a tensor outside ``server_state``."""

    @staticmethod
    def get_persistent(trainer):
        return {"teacher": {"w": trainer.teacher_w}, "step": 3}

    @staticmethod
    def set_persistent(trainer, tree):
        trainer.teacher_w = tree["teacher"]["w"]
        trainer.restored_step = tree["step"]


def test_persistent_protocol_round_trips_tensors(tmp_path):
    t1 = Trainer(_cfg(), device="cpu")
    t1.algo = _PersistentAlgo
    t1.teacher_w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    t1.server_state = {"flag": True, "table": torch.ones(2, dtype=torch.int64),
                       "host": np.arange(3, dtype=np.int8), "none": None}
    f = save_checkpoint(str(tmp_path), t1, 0)
    t2 = Trainer(_cfg(), device="cpu")
    t2.algo = _PersistentAlgo
    load_checkpoint(f, t2)
    assert torch.equal(t2.teacher_w, t1.teacher_w) and t2.restored_step == 3
    st = t2.server_state
    assert st["flag"] is True and st["none"] is None
    assert torch.equal(st["table"], torch.ones(2, dtype=torch.int64))
    assert isinstance(st["host"], np.ndarray) and st["host"].dtype == np.int8


def test_cli_main_writes_metrics_and_checkpoints_and_resumes(tmp_path):
    """``main`` on the CPU: FedAVG, 3 rounds, a checkpoint every round and
    at the ``rounds_corr`` milestone; ``--resume`` continues from a
    checkpoint; ``--train 0 --resume`` runs the per-class test branch."""
    out = str(tmp_path)
    argv = _SMALL + ["--exp", "FedAVG", "--rounds", "3", "--checkpoint_every", "2",
                     "--rounds_corr", "1", "--eval_every", "3", "--output_dir", out]
    TCli.main(argv)
    exp = os.path.join(out, "FedAVG_synthetic")
    models = os.path.join(exp, "models")
    # every 2nd round, plus the rounds_corr milestone after round 0
    assert sorted(os.listdir(models)) == ["ckpt_0.pkl", "ckpt_1.pkl"]
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert all(set(r) == {"tag", "value", "step", "time"} for r in recs)
    losses = [r for r in recs if r["tag"].startswith("train_run0/warm-up-loss/client")]
    assert len(losses) == 3 * 5 and all(np.isfinite(r["value"]) for r in losses)
    assert {r["tag"] for r in recs if r["step"] == 2} >= {
        "test_run0/mAP", "test_run0/auc", "test_run0/BACC"}
    assert os.path.getsize(os.path.join(exp, "logs", "logs.txt")) > 0

    # resume from round 1's checkpoint: only round 2 runs again, same losses
    TCli.main(argv + ["--resume", os.path.join(models, "ckpt_1.pkl")])
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as fh:
        again = [json.loads(line) for line in fh][len(recs):]
    assert {r["step"] for r in again} == {2}
    first = {r["tag"]: r["value"] for r in recs if r["step"] == 2}
    assert {r["tag"]: r["value"] for r in again} == first

    # the test-only branch
    TCli.main(argv + ["--train", "0", "--resume", os.path.join(models, "ckpt_1.pkl")])
    with open(os.path.join(exp, "logs", "logs.txt")) as fh:
        log = fh.read()
    assert log.count("-----> BACC:") == 5


def test_cli_multi_run_reseeds(tmp_path):
    TCli.main(_SMALL + ["--exp", "FedAVG", "--rounds", "1", "--runs", "2",
                        "--n_clients", "2", "--output_dir", str(tmp_path)])
    with open(os.path.join(str(tmp_path), "FedAVG_synthetic", "logs",
                           "metrics.jsonl")) as fh:
        tags = {json.loads(line)["tag"].split("/")[0] for line in fh}
    assert tags == {"train_run0", "test_run0", "train_run1", "test_run1"}


def test_cli_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    argv = [a for a in _SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCli.main(argv + ["--exp", "FedAVG", "--output_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
