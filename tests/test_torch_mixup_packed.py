"""The port's packed datasets from disk (data/datasets.py), mixup
(ops/mixup.py), FedMLP's stage-2 mixup loss and its routing
(algos/fedmlp.py), ``Trainer.apply_corrections`` and converted weights in
the Trainer, against the JAX package where it has a counterpart, and the
CLI on a packed shard with ResNet-18.

Mixup's draws differ between the frameworks (threefry against torch
generators), so the step test passes JAX's lam and permutation, drawn from
its key, to the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.algos import fedmlp as jfedmlp
from fedmlp_tpu.config import Config as JConfig, DataConfig as JData, FedMLPConfig as JFed
from fedmlp_tpu.data import datasets as JD
from fedmlp_tpu.models import smallcnn as JS
from fedmlp_tpu.ops import mixup as JM
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch import cli as TCli
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData, FedMLPConfig as TFed
from fedmlp_tpu_torch.data import datasets as TD
from fedmlp_tpu_torch.models import factory as TF
from fedmlp_tpu_torch.models import smallcnn as TS
from fedmlp_tpu_torch.ops import mixup as TM
from fedmlp_tpu_torch.train import Trainer as TTrainer
from fedmlp_tpu_torch.weights import leaf_to_jax, to_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C, B, IMG = 4, 8, 16


# ----------------------------------------------------------------------
# packed datasets
# ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_packed_shard_reads_the_same_in_both_packages(tmp_path, writer):
    """A shard written by either package's ``save_packed_dataset`` reads
    back the same through both ``load_packed_dataset``s, mapped or not:
    images, targets, class names and name."""
    ds = TD.make_synthetic_dataset(12, C, IMG, seed=3, name="ich_small")
    save = (JD if writer == "jax" else TD).save_packed_dataset
    save(JD.ArrayDataset(ds.images, ds.targets, ds.class_names, ds.name)
         if writer == "jax" else ds, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["images.npy", "meta.json", "targets.npy"]
    for mmap in (True, False):
        j = JD.load_packed_dataset(str(tmp_path), mmap=mmap)
        t = TD.load_packed_dataset(str(tmp_path), mmap=mmap)
        assert isinstance(t, TD.ArrayDataset)
        for got in (j, t):
            np.testing.assert_array_equal(got.images, ds.images)
            np.testing.assert_array_equal(got.targets, ds.targets)
            assert tuple(got.class_names) == ds.class_names and got.name == "ich_small"
        assert t.targets.dtype == np.float32 and t.images.dtype == np.uint8


def test_csv_png_ingest_matches_jax(tmp_path):
    """The reference's CSV schema over a few PNGs of other sizes and modes
    (RGB, gray, RGBA): both packages decode, convert and resize them to the
    same bytes, with the same targets; ``limit`` keeps the first rows."""
    from PIL import Image

    rng = np.random.RandomState(4)
    names = ("epidural", "subdural", "any")
    rows = []
    for i, (mode, shape) in enumerate((("RGB", (20, 24, 3)), ("L", (9, 9)),
                                       ("RGBA", (31, 17, 4)))):
        fname = f"img{i}.png"
        Image.fromarray(rng.randint(0, 256, shape, np.uint8), mode).save(tmp_path / fname)
        rows.append({"image": fname, **{n: int(rng.rand() > 0.5) for n in names}})
    csv = tmp_path / "labels.csv"
    with open(csv, "w") as f:
        f.write(",".join(("image",) + names) + "\n")
        for r in rows:
            f.write(",".join(str(r[k]) for k in ("image",) + names) + "\n")
    for limit in (None, 2):
        j = JD.load_csv_png_dataset(str(csv), str(tmp_path), names, image_size=IMG,
                                    limit=limit, name="ich")
        t = TD.load_csv_png_dataset(str(csv), str(tmp_path), names, image_size=IMG,
                                    limit=limit, name="ich")
        assert t.images.shape == (limit or 3, IMG, IMG, 3)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.targets, j.targets)
        assert t.class_names == tuple(j.class_names) and t.name == j.name


# ----------------------------------------------------------------------
# mixup
# ----------------------------------------------------------------------

def test_draw_mixup_is_uniform_and_a_permutation():
    """lam ~ U(0, 1) = Beta(1, 1) (mean, variance and quartiles of 4000
    draws), perm a uniform permutation of the batch (each position takes
    each row about equally often), both from the generator (a reseeded
    generator repeats them)."""
    g = torch.Generator().manual_seed(5)
    lams, perms = [], []
    for _ in range(4000):
        lam, perm = TM.draw_mixup(g, 8)
        assert lam.dtype == torch.float32 and lam.dim() == 0
        assert sorted(perm.tolist()) == list(range(8))
        lams.append(float(lam))
        perms.append(tuple(perm.tolist()))
    lams = np.asarray(lams)
    assert 0.0 <= lams.min() and lams.max() < 1.0
    assert abs(lams.mean() - 0.5) < 0.02 and abs(lams.var() - 1 / 12) < 0.01
    np.testing.assert_allclose(np.quantile(lams, [0.25, 0.5, 0.75]), [0.25, 0.5, 0.75],
                               atol=0.03)
    counts = np.zeros((8, 8))
    for p in perms:
        counts[np.arange(8), p] += 1
    assert np.abs(counts - 500).max() < 5 * np.sqrt(4000 * (1 / 8) * (7 / 8))
    again = TM.draw_mixup(torch.Generator().manual_seed(5), 8)
    assert float(again[0]) == lams[0] and tuple(again[1].tolist()) == perms[0]


def test_mixup_ops_match_jax():
    """mixup_images, mixup_batch and mixup_criterion with JAX's own draws."""
    rng = np.random.RandomState(6)
    x = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    y = (rng.rand(B, C) > 0.5).astype(np.float32)
    mixed, perm, lam = JM.mixup_images(jnp.asarray(x), jax.random.PRNGKey(3))
    tlam, tperm = torch.tensor(np.asarray(lam)), torch.tensor(np.asarray(perm))
    got = TM.mixup_images(torch.from_numpy(x), tlam, tperm)
    np.testing.assert_allclose(got.numpy(), np.asarray(mixed), rtol=0, atol=1e-6)
    jb = JM.mixup_batch(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(3))
    tb = TM.mixup_batch(torch.from_numpy(x), torch.from_numpy(y), tlam, tperm)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)
    p = 1.0 / (1.0 + np.exp(-rng.randn(B, C).astype(np.float32)))

    def mse(q, t):
        return ((q - t) ** 2).mean()

    want = JM.mixup_criterion(mse, jnp.asarray(p), jb[1], jb[2], jb[3])
    got = TM.mixup_criterion(mse, torch.from_numpy(p), tb[1], tb[2], tb[3])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_stage2_mixup_step_matches_jax(monkeypatch):
    """One stage-2 mixup step on smallcnn, the last batch row padding, with
    JAX's lam and perm (from the key's first half, as its loss splits it)
    handed to the port: the loss, every parameter's gradient and the
    batch-norm statistics agree; both mixed halves count only where both
    samples are real."""
    tm = TF.init_model(TS.SmallCNN(C), seed=2)
    v = to_jax_variables(tm.state_dict())
    rng = np.random.RandomState(7)
    x = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    labels = (rng.rand(B, C) > 0.5).astype(np.float32)
    supmask = (rng.rand(B, C) > 0.4).astype(np.float32)
    svalid = np.arange(B) < B - 1
    key = jax.random.PRNGKey(11)
    _, perm, lam = JM.mixup_images(jnp.asarray(x), jax.random.split(key)[0])
    perm_np = np.asarray(perm)
    assert not (perm_np == np.arange(B)).all() and perm_np[-1] != B - 1

    jm = JS.SmallCNN(C)

    def jloss(params):
        return jfedmlp.stage2_mixup_loss_fn(
            params, {"batch_stats": v["batch_stats"]}, jm, {"x": jnp.asarray(x)},
            {"labels": jnp.asarray(labels), "supmask": jnp.asarray(supmask)},
            jnp.asarray(svalid), {}, None, key, {})

    (jl, (rest1, _)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])

    monkeypatch.setattr(tfedmlp, "draw_mixup", lambda g, b, d: (
        torch.tensor(np.asarray(lam)), torch.tensor(perm_np)))
    tl = tfedmlp.stage2_mixup_loss_fn(
        tm, {"x": torch.from_numpy(x.transpose(0, 3, 1, 2).copy())},
        {"labels": torch.from_numpy(labels), "supmask": torch.from_numpy(supmask)},
        torch.from_numpy(svalid), {}, torch.Generator(), {})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for name, p in tm.named_parameters():
        _, path, g = leaf_to_jax(name, p.grad.numpy())
        want = jgrad
        for k in path:
            want = want[k]
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=1e-5, err_msg=name)
    got_stats = to_jax_variables(tm.state_dict())["batch_stats"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_stats)[0],
                            jax.tree_util.tree_leaves(rest1["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5, err_msg=str(path))


def _cfg(mod, **kw):
    base = dict(algorithm="fedmlp", model="smallcnn", batch_size=B, base_lr=1e-3,
                n_clients=4, local_ep=1, rounds_warmup=3, eval_every=100, seed=7,
                p_pos=0.0, compute_dtype="float32", output_dir="")
    base.update(kw)
    fed = mod[2](rounds_stage1=1, clean_threshold=0.2, noise_threshold=0.2,
                 mixup=base.pop("mixup", 0))
    data = mod[1](name="synthetic", n_classes=C, image_size=IMG,
                  synthetic_train_size=64, synthetic_test_size=16)
    return mod[0](**base, fedmlp=fed, data=data)


_TORCH = (TConfig, TData, TFed)
_JAX = (JConfig, JData, JFed)


def test_trainer_stage2_mixup_rounds(monkeypatch):
    """Three rounds with ``fedmlp.mixup`` (one stage-1 round that harvests,
    two stage-2 rounds): the stage-2 rounds go through the mixup loss, the
    losses and weights stay finite, and a run without mixup never calls
    it and trains to other weights."""
    calls = []
    real = tfedmlp.stage2_mixup_loss_fn

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tfedmlp, "stage2_mixup_loss_fn", spy)
    runs = {}
    for mixup in (1, 0):
        calls.clear()
        t = TTrainer(_cfg(_TORCH, mixup=mixup), device="cpu")
        for r in range(3):
            rec = t.run_round(r)
            assert np.isfinite(rec.client_losses).all()
        assert (len(calls) > 0) == bool(mixup)
        assert all(torch.isfinite(v).all() for v in t.global_vars.values())
        assert (t.server_state["tags"] > 0).any()
        runs[mixup] = t
    assert calls == []
    assert runs[1].history[1].client_losses != runs[0].history[1].client_losses


def test_apply_corrections_matches_jax():
    """Both Trainers on one fixture: a missing class's listed samples flip to
    positive (the same count and the same observed-label table), an
    annotated class is never corrected, indices outside a client change
    nothing."""
    jt = JTrainer(_cfg(_JAX), use_mesh=False)
    tt = TTrainer(_cfg(_TORCH), device="cpu")
    active = tt.fd.active.numpy()
    idx, valid = tt.fd.idx.numpy(), tt.fd.valid.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jt.fd.idx))
    k = 1
    c = int(np.where(~active[k])[0][0])
    ca = int(np.where(active[k])[0][0])
    other = idx[0][valid[0]][:2].tolist()  # samples of client 0, not of k
    corr = {k: {c: idx[k][valid[k]][:5].tolist() + other, ca: idx[k][valid[k]][:3].tolist()},
            2: {int(np.where(~active[2])[0][-1]): idx[2][valid[2]][-4:].tolist()}}
    n_j, n_t = jt.apply_corrections(corr), tt.apply_corrections(corr)
    assert n_t == n_j > 0
    np.testing.assert_array_equal(tt.fd.obs_targets.numpy(), np.asarray(jt.fd.obs_targets))
    before = tt.fd.obs_targets.clone()
    assert tt.apply_corrections({k: {ca: idx[k][valid[k]].tolist()}}) == 0
    assert tt.apply_corrections(corr) == 0  # already positive
    assert torch.equal(tt.fd.obs_targets, before)


def test_trainer_loads_converted_weights(tmp_path):
    """``cfg.pretrained_path``: every backbone array of the npz is in the
    Trainer's model after init (and so in its global variables); the head,
    which the file leaves out, keeps the seed's init."""
    src = TF.init_model(TF.build_model("resnet18", C), seed=99).state_dict()
    flat = {}
    for name, t in src.items():
        if not name.startswith("head."):
            coll, path, a = leaf_to_jax(name, t.numpy())
            flat["/".join((coll,) + path)] = a
    npz = tmp_path / "r18.npz"
    np.savez(npz, **flat)
    t = TTrainer(_cfg(_TORCH, model="resnet18", algorithm="fedavg",
                      pretrained_path=str(npz)), device="cpu")
    fresh = TF.init_model(TF.build_model("resnet18", C), seed=7).state_dict()
    for name, v in t.global_vars.items():
        want = fresh[name] if name.startswith("head.") else src[name]
        assert torch.equal(v, want), name


# ----------------------------------------------------------------------
# the CLI on a packed shard
# ----------------------------------------------------------------------

def _shard(root):
    for part, n, seed in (("train", 48, 0), ("test", 16, 1)):
        TD.save_packed_dataset(TD.make_synthetic_dataset(n, C, IMG, seed=seed,
                                                         name="shard"),
                               os.path.join(root, part))


def test_cli_runs_resnet18_on_a_packed_shard(tmp_path):
    """``--exp FedMLP --model Resnet18 --data_root <shard> --device cpu``
    with ``--mixup 1``: one stage-1 and one stage-2 round on the shard read
    from disk, each round's losses logged and checkpointed; without
    ``--device cpu`` and without a card it raises instead of running on the
    CPU."""
    root = str(tmp_path / "shard")
    _shard(root)
    out = str(tmp_path / "out")
    argv = ["--exp", "FedMLP", "--model", "Resnet18", "--data_root", root,
            "--dataset", "synthetic", "--n_classes", str(C), "--image_size", str(IMG),
            "--n_clients", "4", "--batch_size", str(B), "--base_lr", "1e-3",
            "--rounds", "2", "--rounds_FedMLP_stage1", "1", "--mixup", "1",
            "--eval_every", "2", "--checkpoint_every", "1", "--compute_dtype", "float32",
            "--output_dir", out,
            "--exp_tag", "r18"]
    TCli.main(argv + ["--device", "cpu"])
    with open(os.path.join(out, "r18", "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["value"] for r in recs if "/warm-up-loss/client" in r["tag"]]
    assert len(losses) == 2 * 4 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(out, "r18", "models", "ckpt_1.pkl"))
    assert any(r["tag"].startswith("test_run0/") for r in recs)
    # the partition cache is keyed by the shard's name and size
    assert os.listdir(os.path.join(out, "iid-dictusers")) == ["shard_48_1037_4.npy"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCli.main(argv)
