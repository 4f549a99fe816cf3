"""The scenarios of ``tests/test_torch_mesh.py``, run in every process of one
group of two gloo ranks (``fedmlp_tpu_torch.parallel.mesh.launch``). The
module imports torch, numpy and the port, never JAX; the test file holds
the JAX side and compares. Each scenario returns numpy arrays and lists, so
the parent reads them without the port's objects."""

import numpy as np
import torch

from fedmlp_tpu_torch.config import (
    Config,
    DataConfig,
    FedMLPConfig,
    MeshConfig,
    RoFLConfig,
)
from fedmlp_tpu_torch.parallel.mesh import Mesh, make_mesh, process_rank
from fedmlp_tpu_torch.train import Trainer

C, IMG = 4, 32

# (a), (d), (e): 3 clients over 2 client shards (a padded axis), views drawn
# by the plain version of the fused warp
SMALL = dict(model="smallcnn", batch_size=8, base_lr=1e-3, n_clients=3, local_ep=1,
             rounds_warmup=2, eval_every=100, seed=5, p_pos=0.0, compute_dtype="float32",
             output_dir="", fedmlp=FedMLPConfig(rounds_stage1=1, clean_threshold=0.2,
                                                noise_threshold=0.2),
             rofl=RoFLConfig(forget_rate=0.2, num_gradual=10, T_pl=2, lambda_cen=1.0,
                             lambda_e=0.8))
SMALL_DATA = dict(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=96,
                  synthetic_test_size=16)

# (b): tests/test_fedmlp_shard_equivalence.py's run, 'normonly' views
FEDMLP = dict(algorithm="fedmlp", model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=8, local_ep=1, rounds_warmup=3, eval_every=10_000, seed=23,
              p_pos=0.0, compute_dtype="float32", client_stacking="off", output_dir="")
FEDMLP_FED = dict(rounds_stage1=1, clean_threshold=0.2, noise_threshold=0.2)
FEDMLP_DATA = dict(name="synthetic", n_classes=C, image_size=IMG, synthetic_train_size=128,
                   synthetic_test_size=16, augment_backend="normonly")


class SoloTrainer(Trainer):
    """One rank's trainer whose rounds run as under any mesh (client k on a
    generator of its own): the unsharded run that a sharded one equals."""

    @property
    def round_mesh(self):
        return Mesh(1, 1, device=self.device)


def _np(tree: dict) -> dict:
    return {n: v.detach().cpu().numpy() for n, v in tree.items()}


def _summary(tr, losses) -> dict:
    st = {n: np.asarray(v) for n, v in tr.server_state.items() if isinstance(v, np.ndarray)}
    return {"losses": losses, "vars": _np(tr.global_vars), "state": st,
            "generator": tr.generator.get_state().numpy(), "host": tr.rng.get_state()[1]}


def _rounds(tr, n: int) -> dict:
    return _summary(tr, [tr.run_round(r).client_losses for r in range(n)])


def _small(algorithm: str, mesh=MeshConfig(), **data_kw) -> Config:
    return Config(algorithm=algorithm, **SMALL, mesh=mesh,
                  data=DataConfig(**SMALL_DATA, **data_kw))


# the rank that runs each scenario's one-rank reference, after every
# sharded run (the two ranks share that work)
SOLO_RANK = {"fedavg": 0, "rscfed": 1, "rofl": 0, "centralized": 1, "stream": 1,
             "fedmlp_off": 0, "fedmlp_on": 1}


def client_axis(algorithm: str) -> tuple:
    """(a), (d): two rounds sharded over the two ranks ('centralized': one
    client, so rank 1 holds none); and the same rounds on one rank."""
    cfg = _small(algorithm)
    tr = Trainer(cfg, device="cpu")
    assert tr.round_mesh.client_shards == 2 and tr.round_mesh.data_shards == 1
    sharded = _rounds(tr, 2)
    if algorithm == "rscfed":
        sharded["teacher"] = _np(tr._rscfed_teacher)

    def solo():
        solo = SoloTrainer(cfg, device="cpu")
        out = _rounds(solo, 2)
        if algorithm == "rscfed":
            out["teacher"] = _np(solo._rscfed_teacher)
        return out

    return sharded, solo


def fedmlp_vs_jax(init: dict, engine: str) -> tuple:
    """(b): FedMLP across stage 1 → stage 2 from JAX's initial weights, on
    the per-client loop ('off') or the lockstep engine ('on'); and the same
    rounds without a mesh ('normonly' views and smallcnn draw nothing, so
    the streams do not differ)."""
    cfg = Config(**FEDMLP, batched_global=engine, fedmlp=FedMLPConfig(**FEDMLP_FED),
                 data=DataConfig(**FEDMLP_DATA))

    def run(tr):
        tr.global_vars = {n: torch.from_numpy(v) for n, v in init.items()}
        return _rounds(tr, 2)

    tr = Trainer(cfg, device="cpu")
    assert tr.round_mesh.client_shards == 2
    return run(tr), lambda: run(Trainer(cfg, device="cpu", use_mesh=False))


def data_axis(inputs: dict) -> dict:
    """(c): one FedAVG round of the per-client loop over a 1 x 2 mesh (each
    rank half of every step's batch) on the test's federation and plan."""
    from fedmlp_tpu_torch.algos import fedavg
    from fedmlp_tpu_torch.models import build_model
    from fedmlp_tpu_torch.parallel import fl_runtime as rt

    fd = rt.build_federated_data(inputs["images"], inputs["targets"], inputs["users"],
                                 inputs["hidden"], inputs["active"], device="cpu")
    mesh = make_mesh(1, 2)
    assert (mesh.client_shards, mesh.data_shards) == (1, 2)
    round_fn = rt.make_local_round(build_model("smallcnn", C), fedavg.loss_fn, lr=1e-3,
                                   batch_size=inputs["batch_size"], mean=inputs["mean"],
                                   std=inputs["std"], augment_backend="normonly", mesh=mesh)
    gv = {n: torch.from_numpy(v) for n, v in inputs["init"].items()}
    out, losses, _ = round_fn(gv, {"images": fd.images, "idx": fd.idx,
                                   "ctx": {"loss_w": fd.loss_w}},
                              {"pos": inputs["pos"], "pos_valid": inputs["pos_valid"],
                               "sample": {"labels": fd.obs_targets}},
                              {"rnd": 0.0}, torch.Generator().manual_seed(0))
    return {"vars": _np(out["vars"]), "losses": losses.numpy()}


def streamed(npy: str) -> tuple:
    """(e): FedMLP streamed from the shard in windows of 2 steps, sharded;
    and the same rounds resident, unwindowed, on one rank."""
    from fedmlp_tpu_torch.data.datasets import load_packed_dataset

    root = npy.rsplit("/train/", 1)[0]
    train = load_packed_dataset(f"{root}/train")
    test = load_packed_dataset(f"{root}/test")
    tr = Trainer(_small("fedmlp", host_stream=True, stream_window=2), train_ds=train,
                 test_ds=test, device="cpu", images_npy=npy)
    assert tr.loader is not None and tr.round_mesh.client_shards == 2
    return _rounds(tr, 2), lambda: _rounds(
        SoloTrainer(_small("fedmlp"), train_ds=train, test_ds=test, device="cpu"), 2)


def cli_resume(root: str) -> dict:
    """The CLI inside the group (as under ``torchrun``): FedAVG, 3 clients,
    2 rounds with a checkpoint after each, rank r writing under
    ``root/rank{r}``; then both ranks resume from rank 0's checkpoint of
    round 0 and run round 1 again. Returns each run's rounds as recorded by
    ``Trainer.run_round`` (losses and the global variables), and which files
    this rank's output directory holds."""
    import os

    import torch.distributed as dist

    from fedmlp_tpu_torch import cli

    out = os.path.join(root, f"rank{process_rank()}")
    argv = ["--exp", "FedAVG", "--dataset", "synthetic", "--model", "smallcnn",
            "--device", "cpu", "--compute_dtype", "float32", "--rounds", "2",
            "--n_clients", "3", "--batch_size", "8", "--image_size", str(IMG),
            "--n_classes", str(C), "--synthetic_train_size", "48",
            "--synthetic_test_size", "16", "--eval_every", "100",
            "--checkpoint_every", "1", "--output_dir", out]
    seen, run_round = [], Trainer.run_round

    def recording(self, rnd):
        rec = run_round(self, rnd)
        seen.append((rnd, rec.client_losses, _np(self.global_vars)))
        return rec

    Trainer.run_round = recording
    try:
        cli.main(argv)
        straight = list(seen)
        dist.barrier()  # rank 0's checkpoints are on disk
        seen.clear()
        ckpt = os.path.join(root, "rank0", "FedAVG_synthetic", "models", "ckpt_0.pkl")
        cli.main(argv + ["--resume", ckpt])
    finally:
        Trainer.run_round = run_round
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    return {"straight": straight, "resumed": list(seen), "files": files}


def data_shards_fedmlp() -> dict:
    """FedMLP (3 clients, views drawn) with ``mesh.data_axis=2``: over two
    ranks a 1 x 2 mesh, over four a 2 x 2 one (client and data groups of
    their own); the two equal bit for bit."""
    tr = Trainer(_small("fedmlp", mesh=MeshConfig(data_axis=2)), device="cpu")
    out = _rounds(tr, 2)
    out["mesh"] = (tr.round_mesh.client_shards, tr.round_mesh.data_shards)
    return out


def jax_inputs(root: str, timeout_s: float = 30.0) -> dict:
    """What the test computes with JAX for the group (the FedMLP trainer's
    initial weights, the data-axis scenario's inputs): it writes
    ``root/jax_inputs.pt`` while the group runs its first scenarios."""
    import os
    import time

    path = os.path.join(root, "jax_inputs.pt")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def run_scenarios(root: str) -> dict:
    """Every sharded run, then the one-rank references, each on its
    ``SOLO_RANK``. ``root`` holds the packed shard (``train``, ``test``)
    and, once the test has written it, ``jax_inputs.pt``."""
    import os

    torch.set_num_threads(1)
    out, solos = {"data_shards": data_shards_fedmlp()}, {}
    for name in ("fedavg", "rscfed", "rofl", "centralized"):
        out[name], solos[name] = client_axis(name)
    out["stream"], solos["stream"] = streamed(os.path.join(root, "train", "images.npy"))
    out["cli"] = cli_resume(os.path.join(root, "cli"))
    jax = jax_inputs(root)
    for engine in ("off", "on"):
        out[f"fedmlp_{engine}"], solos[f"fedmlp_{engine}"] = fedmlp_vs_jax(
            jax["fedmlp_init"], engine)
    out["data_axis"] = data_axis(jax["data_axis"])
    out["solo"] = {name: run() for name, run in solos.items()
                   if SOLO_RANK[name] == process_rank()}
    return out


def run_on_four_then_raise(root: str) -> None:
    """(g) and (f) in one group of four ranks: the 2 x 2 FedMLP run, each
    rank's result saved to ``root/four{rank}.pt``; then rank 1 raises while
    the others wait in a barrier."""
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.save(data_shards_fedmlp(), os.path.join(root, f"four{process_rank()}.pt"))
    dist.barrier()  # every rank's result is on disk
    if process_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
