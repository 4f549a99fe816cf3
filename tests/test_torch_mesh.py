"""The port's process mesh (fedmlp_tpu_torch/parallel/mesh.py) on the CPU.

One group of two gloo ranks, spawned once for the module, runs every
scenario of ``tests/torch_mesh_worker.py`` (which imports no JAX) while this
process computes the JAX package's side:

  (a) FedAVG, 3 clients over 2 client shards (padded), views drawn: equal
      bits to one rank on the same per-client streams;
  (b) FedMLP across stage 1 → stage 2 with the harvests, 'normonly', on the
      per-client loop and the lockstep engine, against one JAX ``Trainer``
      (the per-client loop) on its 8-device mesh;
  (c) the data axis (1 client x 2 data shards) against JAX's
      ``make_local_round`` on a 1 x 2 mesh, the two ranks holding equal bits;
  (d) RSCFed's teacher and RoFL's per-client state (and harvest) on the
      client axis: equal bits to one rank;
  (e) FedMLP streamed in windows of 2 steps, sharded, against resident,
      unwindowed and unsharded;
  (h) the CLI inside the group: only rank 0 writes, and a resume from its
      checkpoint equals the straight run on both ranks.

A second group, of four ranks, then runs (g) FedMLP over a 2 x 2 mesh (client
and data groups of their own), which equals it over 1 x 2 bit for bit, and
(f): rank 1 raises, and the launcher raises.

smallcnn at 32 px, float32. Each launch has a 60 s limit, so a hang fails
its test instead of running the suite's clock out."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import fedavg as jfedavg
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.data import masking as JM
from fedmlp_tpu.models import build_model as jbuild
from fedmlp_tpu.models.factory import init_model as jinit
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu.parallel.mesh import make_mesh as jmake_mesh
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.config import Config, DataConfig, MeshConfig
from fedmlp_tpu_torch.data.datasets import make_synthetic_dataset, save_packed_dataset
from fedmlp_tpu_torch.parallel import fl_runtime as trt
from fedmlp_tpu_torch.parallel.mesh import launch, pad_clients, pick_backend
from fedmlp_tpu_torch.train import UnportedConfigError, check_ported
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
import torch_mesh_worker as W

LAUNCH_TIMEOUT_S = 60
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DATA_B = 8


def _jax_fedmlp():
    cfg = JConfig(**W.FEDMLP, batched_global="off", fedmlp=JFed(**W.FEDMLP_FED),
                  data=JData(**W.FEDMLP_DATA))
    return JTrainer(cfg, use_mesh=True)


def _data_axis_inputs() -> dict:
    """Two clients of 12 and 20 images at batch 8: client 0's second step
    has 4 real rows, so its second data shard's rows are all padding there,
    and its third step is padding throughout."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (32, W.IMG, W.IMG, 3), np.uint8)
    targets = (rng.rand(32, W.C) > 0.5).astype(np.float32)
    users = {0: list(range(12)), 1: list(range(12, 32))}
    hidden = JM.build_hidden_mask(targets, 0.0, np.random.RandomState(0))
    jfd = jrt.build_federated_data(images, targets, users, hidden, [[0], [1]])
    pos, pos_valid, _ = jrt.make_batch_plan(np.random.RandomState(1), np.asarray(jfd.valid),
                                            DATA_B, 1)
    model = jbuild("smallcnn", W.C, compute_dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jinit(model, jax.random.PRNGKey(0), W.IMG,
                                                 batch=2))
    return {"images": images, "targets": targets, "users": users, "hidden": hidden,
            "active": [[0], [1]], "pos": pos, "pos_valid": pos_valid, "batch_size": DATA_B,
            "mean": MEAN, "std": STD, "jfd": jfd, "model": model, "v": v,
            "init": {n: t.numpy() for n, t in from_jax_variables(v).items()}}


def _jax_data_axis(inp: dict) -> dict:
    jfd, v = inp["jfd"], inp["v"]
    mesh = jmake_mesh(1, 2, devices=jax.devices()[:2])
    jround = jrt.make_local_round(inp["model"], jfedavg.loss_fn, lr=1e-3, batch_size=DATA_B,
                                  mean=MEAN, std=STD, donate=False, mesh=mesh,
                                  augment_backend="normonly")
    pos = jnp.asarray(inp["pos"])
    imgs, sample = jrt.gather_round_data(jfd.images, jfd.idx, {"labels": jfd.obs_targets},
                                         pos)
    plan = {"images": imgs, "sample": sample, "pos": pos,
            "pos_valid": jnp.asarray(inp["pos_valid"]), "key": jax.random.PRNGKey(0),
            "iter0": jnp.float32(0)}
    out, losses, _ = jround({"vars": jrt.broadcast_to_clients(v, 2)},
                            {"ctx": {"loss_w": jfd.loss_w}, "global_vars": v}, plan,
                            {"rnd": jnp.float32(0)})
    per_client = [from_jax_variables(jax.tree_util.tree_map(lambda x: np.asarray(x[k]),
                                                            out["vars"]))
                  for k in range(2)]
    return {"losses": np.asarray(losses),
            "vars": {n: np.stack([c[n].numpy() for c in per_client]) for n in per_client[0]}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every scenario's results on both ranks, with the JAX side computed
    here while the groups run (what the group needs of it handed over in
    ``jax_inputs.pt``); then the four-rank group's."""
    d = tmp_path_factory.mktemp("mesh_shard")
    for part, seed in (("train", 5), ("test", 6)):
        n = W.SMALL_DATA["synthetic_train_size" if part == "train" else
                         "synthetic_test_size"]
        save_packed_dataset(make_synthetic_dataset(n, W.C, W.IMG, seed=seed), str(d / part))
    (d / "cli").mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # one group after the other (fewer processes at once on a loaded
        # host), both while this process runs the JAX side
        two = pool.submit(launch, W.run_scenarios, 2, (str(d),), timeout_s=LAUNCH_TIMEOUT_S)
        failing = pool.submit(launch, W.run_on_four_then_raise, 4, (str(d),),
                              timeout_s=LAUNCH_TIMEOUT_S)
        jt = _jax_fedmlp()
        assert jt.round_mesh is not None
        init = {n: t.numpy() for n, t in from_jax_variables(
            jax.tree_util.tree_map(np.array, jt.global_vars)).items()}  # copies: rounds donate
        inp = _data_axis_inputs()
        child = {k: x for k, x in inp.items() if k not in ("jfd", "model", "v")}
        torch.save({"fedmlp_init": init, "data_axis": child}, d / "jax_inputs.part")
        (d / "jax_inputs.part").rename(d / "jax_inputs.pt")  # whole, for the group's poll
        jax_side = {"data_axis": _jax_data_axis(inp),
                    "losses": [jt.run_round(r).client_losses for r in range(2)]}
        jax_side["state"] = {n: np.asarray(jt.server_state[n]) for n in ("tags", "tao",
                                                                         "proto")}
        ranks = two.result()
        jax_side["failing"] = failing.exception()
    jax_side["four"] = [torch.load(d / f"four{r}.pt", weights_only=False)
                        for r in range(4) if (d / f"four{r}.pt").exists()]
    return ranks, jax_side


def _solo(ranks: list, scenario: str) -> dict:
    return ranks[W.SOLO_RANK[scenario]]["solo"][scenario]


def _assert_equal_runs(a: dict, b: dict, generator: bool = True) -> None:
    """Bit-equal losses, global state dict, server state, the host
    generator and, with ``generator``, the torch generator."""
    assert a["losses"] == b["losses"]
    assert a["vars"].keys() == b["vars"].keys()
    for n, v in a["vars"].items():
        np.testing.assert_array_equal(v, b["vars"][n], err_msg=n)
    assert a["state"].keys() == b["state"].keys()
    for n, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][n], err_msg=n)
    if generator:
        np.testing.assert_array_equal(a["generator"], b["generator"])
    np.testing.assert_array_equal(a["host"], b["host"])


@pytest.mark.parametrize("scenario", ["fedavg", "rscfed", "rofl", "centralized", "stream"])
def test_sharded_rounds_equal_one_rank(group, scenario):
    """(a), (d), (e): two rounds over 2 client shards equal the rounds of
    one rank on the same per-client streams, bit for bit, on both ranks
    (RSCFed's persistent teachers too; 'centralized' has one client, so
    the second rank's block is empty)."""
    ranks, _ = group
    solo = _solo(ranks, scenario)
    for r in (0, 1):
        _assert_equal_runs(ranks[r][scenario], solo)
    if scenario == "rscfed":
        for n, v in solo["teacher"].items():
            for r in (0, 1):
                np.testing.assert_array_equal(ranks[r][scenario]["teacher"][n], v,
                                              err_msg=n)
    assert len(solo["losses"][0]) == (1 if scenario == "centralized" else 3)
    if scenario in ("rofl", "stream"):  # harvests ran: centroids or prototypes
        assert any(np.abs(v).sum() > 0 for v in solo["state"].values())


@pytest.mark.parametrize("engine", ["off", "on"])
def test_sharded_fedmlp_matches_unsharded_and_the_jax_trainer_mesh(group, engine):
    """(b): FedMLP, one stage-1 round that harvests and one stage-2 round,
    on 2 client shards in the port and 8 in JAX (both 'normonly', from the
    same weights). The port's sharded run equals its run without a mesh bit
    for bit on both ranks (views and smallcnn draw nothing; only the torch
    generator has moved on by the K per-client seeds), as
    tests/test_fedmlp_shard_equivalence.py holds JAX's sharded run to its
    unsharded one. Both engines are held to JAX's sharded per-client loop
    (as tests/test_lockstep_round.py holds JAX's lockstep engine to it):
    client losses within rtol 1e-4, the tags equal, τ within 1e-6 and
    prototypes within atol 1e-3 (the port's other JAX comparisons' bound:
    Adam's first steps carry float noise of the two frameworks into the
    stage-2 features)."""
    ranks, want = group
    key = f"fedmlp_{engine}"
    port = ranks[0][key]
    for r in (0, 1):
        _assert_equal_runs(ranks[r][key], _solo(ranks, key), generator=False)
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(port["state"]["tags"], want["state"]["tags"])
    assert (port["state"]["tags"] > 0).sum() > 0, "tagging selected nothing"
    np.testing.assert_allclose(port["state"]["tao"], want["state"]["tao"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port["state"]["proto"], want["state"]["proto"], rtol=0,
                               atol=1e-3)


def test_data_axis_matches_the_jax_round(group):
    """(c): one FedAVG round over 1 client x 2 data shards (a data shard
    whose rows are all padding in a real step included) against JAX's round
    on its 1 x 2 mesh: client losses and the batch-norm statistics within
    rtol 1e-4, the parameters within atol 1e-4 (the bound of the port's
    other JAX comparisons after Adam steps: a weight whose gradient is near
    0 moves by up to lr whichever way the float noise points). The two ranks
    hold equal bits."""
    ranks, jax_side = group
    got, want = ranks[0]["data_axis"], jax_side["data_axis"]
    for n, v in got["vars"].items():
        np.testing.assert_array_equal(v, ranks[1]["data_axis"]["vars"][n], err_msg=n)
    np.testing.assert_array_equal(got["losses"], ranks[1]["data_axis"]["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["vars"].keys() == want["vars"].keys()
    for n, v in got["vars"].items():
        if "running" in n:
            np.testing.assert_allclose(v, want["vars"][n], rtol=1e-4, atol=1e-6, err_msg=n)
        else:
            np.testing.assert_allclose(v, want["vars"][n], rtol=0, atol=1e-4, err_msg=n)
    assert any("running" in n for n in got["vars"])


def test_the_cli_in_a_group_writes_on_rank_zero_and_resumes(group):
    """(h): ``cli.main`` on both ranks (as under ``torchrun``), rank r given
    its own output directory: rank 0's holds the logs, metrics and a
    checkpoint a round, rank 1's holds nothing. Both ranks, resumed from
    rank 0's checkpoint of round 0, run round 1 to the straight run's bits."""
    ranks, _ = group
    cli = [r["cli"] for r in ranks]
    assert cli[1]["files"] == []
    assert {"FedAVG_synthetic/logs/metrics.jsonl", "FedAVG_synthetic/logs/logs.txt",
            "FedAVG_synthetic/models/ckpt_0.pkl",
            "FedAVG_synthetic/models/ckpt_1.pkl"} <= set(cli[0]["files"])
    for c in cli:
        assert [s[0] for s in c["straight"]] == [0, 1]
        assert [s[0] for s in c["resumed"]] == [1]
        (_, want_losses, want_vars), (_, losses, got) = c["straight"][1], c["resumed"][0]
        assert losses == want_losses
        for n, v in want_vars.items():
            np.testing.assert_array_equal(got[n], v, err_msg=n)
            np.testing.assert_array_equal(cli[0]["straight"][1][2][n], v, err_msg=n)


def test_a_2x2_mesh_equals_a_1x2_mesh(group):
    """(g): FedMLP, views drawn, ``mesh.data_axis=2``: over four ranks (2
    client x 2 data shards) the same two rounds, bit for bit, as over two
    (1 x 2), on every rank."""
    ranks, jax_side = group
    ref = ranks[0]["data_shards"]
    assert ref["mesh"] == (1, 2)
    assert len(jax_side["four"]) == 4
    for run in [r["data_shards"] for r in ranks] + jax_side["four"]:
        _assert_equal_runs(run, ref)
    assert [r["mesh"] for r in jax_side["four"]] == [(2, 2)] * 4


def test_a_raising_rank_fails_the_launcher(group):
    """(f): rank 1 of the four raises while the others wait in a barrier:
    the launcher raises (rank 1's exit), not its timeout."""
    err = group[1]["failing"]
    assert err is not None and not isinstance(err, TimeoutError), err
    assert "exit code 1" in str(err), err


def test_padding_and_the_backend_rule():
    """The padded client count, and the backend rule on the CPU."""
    assert [pad_clients(k, 2) for k in (1, 2, 3, 20)] == [2, 2, 4, 20]
    assert trt.padded_client_count(20, 8) == 24
    assert pick_backend("cpu", 2) == "gloo"


def _cfg(**kw) -> Config:
    base = dict(algorithm="fedavg", model="smallcnn", batch_size=8, n_clients=4,
                compute_dtype="float32", output_dir="",
                data=DataConfig(name="synthetic", n_classes=4, image_size=32))
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("kw,world,fields", [
    (dict(mesh=MeshConfig(data_axis=2)), 1, ("mesh.data_axis",)),
    (dict(mesh=MeshConfig(data_axis=3)), 2, ("mesh.data_axis",)),
    (dict(mesh=MeshConfig(client_axis=2)), 2, ("mesh.client_axis",)),
    (dict(batch_size=9, mesh=MeshConfig(data_axis=2)), 2, ("batch_size", "mesh.data_axis")),
    (dict(algorithm="rofl", mesh=MeshConfig(data_axis=2)), 2,
     ("algorithm", "mesh.data_axis")),
    (dict(algorithm="fedmlp", batched_global="on", mesh=MeshConfig(data_axis=2)), 2,
     ("batched_global", "mesh.data_axis")),
    (dict(client_stacking="on"), 2, ("client_stacking", "mesh.data_axis")),
    (dict(hoist_augment=1, mesh=MeshConfig(data_axis=2)), 2,
     ("hoist_augment", "mesh.data_axis")),
    (dict(hoist_augment=1), 2, ("hoist_augment", "mesh.data_axis")),
    (dict(pre_augment=16), 2, ("pre_augment", "mesh.data_axis")),
])
def test_mesh_refusals_name_their_fields(kw, world, fields):
    """Each refusal of a mesh raises at the check, naming every field
    involved (constructing only: ``check_ported`` with the world given)."""
    with pytest.raises(UnportedConfigError) as e:
        check_ported(_cfg(**kw), world)
    for f in fields:
        assert f"{f}=" in str(e.value), (f, str(e.value))


def test_a_one_process_world_keeps_its_rounds():
    """Outside a group a mesh of one rank is built and the rounds take none
    (``round_mesh`` None); ``use_mesh=False`` builds none."""
    from fedmlp_tpu_torch.train import Trainer

    t = Trainer(_cfg(), device="cpu")
    assert t.mesh.size == 1 and t.round_mesh is None
    assert Trainer(_cfg(), device="cpu", use_mesh=False).mesh is None
