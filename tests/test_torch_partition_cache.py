"""The port's on-disk partition cache against the JAX package's.

Both ``Trainer``s read and write ``<output_dir>/{iid,non-iid}-dictusers/
<name>_<len>_<seed>_<n_clients>[_<alpha>].npy``, a pickled dict of client →
image indices. A cache planted in the output directory wins over the fresh
partition in the port, and a file the port writes is what the JAX package
then trains on. ``smallcnn`` at 32 px, 48 synthetic images, 4 clients.
"""

import os

import numpy as np
import pytest

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.train import Trainer as JTrainer
from fedmlp_tpu_torch.config import Config as TConfig, DataConfig as TData
from fedmlp_tpu_torch.train import Trainer as TTrainer, partition_cache_path
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N_TRAIN, N_CLIENTS, SEED = 48, 4, 5


def _kw(out, iid):
    kw = dict(algorithm="fedavg", model="smallcnn", batch_size=8, base_lr=1e-3,
              n_clients=N_CLIENTS, local_ep=1, eval_every=100, seed=SEED,
              compute_dtype="float32", output_dir=str(out), iid=iid,
              alpha_dirichlet=0.5)
    data = dict(name="synthetic", n_classes=4, image_size=32,
                synthetic_train_size=N_TRAIN, synthetic_test_size=16,
                augment_backend="normonly")
    return kw, data


def _equal(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@pytest.mark.parametrize("iid", [1, 0])
def test_port_trains_on_a_planted_cache(tmp_path, iid):
    kw, data = _kw(tmp_path, iid)
    fresh = TTrainer(TConfig(**dict(kw, output_dir=""), data=TData(**data)),
                     device="cpu").dict_users
    # the same clients, their images dealt round-robin: unlike the fresh draw
    planted = {c: list(range(c, N_TRAIN, N_CLIENTS)) for c in range(N_CLIENTS)}
    assert not _equal(planted, fresh)
    tag = (f"synthetic_{N_TRAIN}_{SEED}_{N_CLIENTS}" + ("" if iid else "_0.5"))
    path = tmp_path / ("iid-dictusers" if iid else "non-iid-dictusers") / f"{tag}.npy"
    path.parent.mkdir()
    np.save(path, planted, allow_pickle=True)
    cfg = TConfig(**kw, data=TData(**data))
    tt = TTrainer(cfg, device="cpu")
    assert partition_cache_path(cfg, tt.train_ds) == str(path)
    assert _equal(tt.dict_users, planted)
    assert tt.n_clients == N_CLIENTS
    assert sorted(int(n) for n in tt.dict_len) == [N_TRAIN // N_CLIENTS] * N_CLIENTS


@pytest.mark.parametrize("iid", [1, 0])
def test_jax_trains_on_the_partition_the_port_wrote(tmp_path, iid):
    kw, data = _kw(tmp_path, iid)
    tt = TTrainer(TConfig(**kw, data=TData(**data)), device="cpu")
    path = partition_cache_path(tt.cfg, tt.train_ds)
    assert os.path.exists(path)
    assert _equal(np.load(path, allow_pickle=True).item(), tt.dict_users)
    stamp = os.stat(path).st_mtime_ns
    jt = JTrainer(JConfig(**kw, data=JData(**data)), use_mesh=False)
    assert os.stat(path).st_mtime_ns == stamp  # read, not written again
    assert _equal(jt.dict_users, tt.dict_users)
    assert sorted(os.listdir(os.path.dirname(path))) == [os.path.basename(path)]


def test_centralized_and_one_client_bypass_the_cache(tmp_path):
    kw, data = _kw(tmp_path, 1)
    tt = TTrainer(TConfig(**dict(kw, n_clients=1), data=TData(**data)), device="cpu")
    assert _equal(tt.dict_users, {0: list(range(N_TRAIN))})
    assert not (tmp_path / "iid-dictusers").exists()
