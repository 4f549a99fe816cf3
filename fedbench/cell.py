"""A cell of the benchmark, found by name, and the inputs it is run on.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The files
are found by name: the configuration at the ``file`` its entry gives, the mix
at ``fedbench/traffic/<traffic>.json``, the limits of the correctness check at
``fedbench/limits/<cell>.json``, the FLOP counter at
``fedbench/flops/<flops>.py``, the plain reference model at
``fedbench/reference/models/<model>.py``. A new cell is new files and new
entries; no file here names a cell.

The inputs are the benchmark's own, made from ``--seed`` on the device: the
images, labels and client split (``make_data``), and the initial weights,
from the reference model's ``init_weights``, which the program is handed.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]  # the checkout
# the FedMLP settings a mix states, under the program's names
FEDMLP_KEYS = ("rounds_stage1", "clean_threshold", "noise_threshold", "L", "U")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None
    root: Path

    @property
    def train_images(self) -> int:
        return self.config["n_clients"] * self.config["train_images_per_client"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; have "
                       f"{sorted(work)}")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits = root / "fedbench" / "limits" / f"{name}.json"
    return Cell(name, int(w["chips"]), _read(root / config["file"]),
                _read(root / "fedbench" / "traffic" / f"{w['traffic']}.json"),
                _read(limits) if limits.exists() else None, root)


def load_file_module(path: Path):
    """A module from a file of its own (a FLOP counter or a metric reader)."""
    spec = importlib.util.spec_from_file_location(f"fedbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(cell: Cell):
    return importlib.import_module(f"fedbench.reference.models.{cell.config['model']}")


def flop_counter(cell: Cell):
    return load_file_module(cell.root / "fedbench" / "flops" / f"{cell.config['flops']}.py")


def program_seed(seed: int) -> int:
    """The seed the program and the reference are given: ``--seed`` modulo
    2**32, the range of ``numpy.random.RandomState``."""
    return int(seed) % 2**32


def build_config(cell: Cell, seed: int):
    """The program's ``Config`` of the cell: the user-facing fields of the
    configuration and the mix; every engine knob at the program's default."""
    from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig

    c, t = cell.config, cell.traffic
    never = 10**9  # no evaluation or last-round work in the window
    data = DataConfig(name=c["dataset"], image_size=c["image_size"], n_classes=c["n_classes"],
                      synthetic_train_size=cell.train_images)
    return Config(seed=program_seed(seed), algorithm=t["algorithm"], model=c["model"],
                  batch_size=c["batch_size"], base_lr=c["base_lr"], n_clients=c["n_clients"],
                  annotation_num=c["annotation_num"], iid=c["iid"], p_pos=c["p_pos"],
                  local_ep=c["local_ep"], compute_dtype=c["compute_dtype"],
                  rounds_warmup=never, eval_every=t.get("eval_every") or never,
                  checkpoint_every=never, output_dir="",
                  fedmlp=FedMLPConfig(**{k: t["fedmlp"][k] for k in FEDMLP_KEYS}), data=data)


def make_data(cell: Cell, generator: torch.Generator, device) -> dict:
    """Synthetic images u8 [N, S, S, 3], multi-label targets [N, C] at the
    configuration's assumed prevalence, and an IID split of equal parts:
    {'images', 'labels' (device tensors), 'dict_users'}. Each image is a
    smooth random field (noise at an eighth of the side, upsampled) plus, for
    each positive class, that class's own smooth pattern."""
    c = cell.config
    N, C, S = cell.train_images, c["n_classes"], c["image_size"]
    prev = torch.tensor(c["assumed"]["label_prevalence"], dtype=torch.float32, device=device)
    labels = (torch.rand((N, C), generator=generator, device=device) < prev).float()
    low = max(S // 8, 2)
    patterns = torch.rand((C, 3 * low * low), generator=generator, device=device)
    base = torch.rand((N, 3, low, low), generator=generator, device=device)
    field = base * 180.0 + 40.0 + (labels @ patterns).reshape(N, 3, low, low) * 35.0
    images = torch.empty((N, S, S, 3), dtype=torch.uint8, device=device)
    for a in range(0, N, 256):  # upsample a block at a time
        up = torch.nn.functional.interpolate(field[a:a + 256], size=(S, S), mode="bilinear",
                                             align_corners=False)
        images[a:a + 256] = up.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    perm = torch.randperm(N, generator=generator, device=device).cpu().numpy()
    per = c["train_images_per_client"]
    dict_users = {k: perm[k * per:(k + 1) * per].tolist() for k in range(c["n_clients"])}
    return {"images": images, "labels": labels, "dict_users": dict_users}


def datasets(cell: Cell, data: dict):
    """(train, test) ``ArrayDataset``s of the program over the same arrays;
    the test set (the first batch of the training images) is never evaluated
    in a window."""
    from fedmlp_tpu_torch.data.datasets import ArrayDataset

    images = data["images"].cpu().numpy()
    labels = data["labels"].cpu().numpy().astype(np.float32)
    names = tuple(f"class{i}" for i in range(labels.shape[1]))
    n_test = cell.config["batch_size"]
    return (ArrayDataset(images, labels, names, name="fedbench"),
            ArrayDataset(images[:n_test], labels[:n_test], names, name="fedbench-test"))


def images_per_round(cell: Cell) -> int:
    """Valid training images a round: every client's split, once an epoch,
    whatever its views."""
    return cell.train_images * cell.config["local_ep"]


def local_steps_per_round(cell: Cell) -> int:
    c = cell.config
    return c["n_clients"] * c["local_ep"] * math.ceil(c["train_images_per_client"]
                                                      / c["batch_size"])
