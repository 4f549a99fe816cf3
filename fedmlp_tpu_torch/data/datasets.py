"""Datasets as packed fixed-shape arrays (numpy copy of
``fedmlp_tpu/data/datasets.py``: the same arrays from the same seed, and
the same packed format on disk, so a shard written by either package reads
the same in both).

Layout: images uint8 [N, H, W, 3] channels-last, as packed on disk; the
weak-view kernel reads this layout and writes NCHW. Targets float32 [N, C]
one-hot multi-label. On disk (``save_packed_dataset``): ``images.npy``,
``targets.npy`` and ``meta.json`` (class names, dataset name).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class ArrayDataset:
    """A packed multi-label image dataset."""

    images: np.ndarray  # uint8 [N, H, W, 3]
    targets: np.ndarray  # float32 [N, C]
    class_names: tuple[str, ...]
    name: str = "dataset"

    def __post_init__(self):
        assert self.images.ndim == 4 and self.images.dtype == np.uint8
        assert self.targets.ndim == 2
        assert len(self.images) == len(self.targets)
        self.targets = self.targets.astype(np.float32)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def n_classes(self) -> int:
        return self.targets.shape[1]


def make_synthetic_dataset(
    n: int,
    n_classes: int,
    image_size: int = 64,
    seed: int = 0,
    name: str = "synthetic",
    class_probs: np.ndarray | None = None,
    signal: float = 150.0,
) -> ArrayDataset:
    """Random-but-learnable fixture: each class plants a class-specific
    spatial pattern with amplitude ``signal`` when positive, so real
    training runs can drive AUC above chance in a few steps."""
    rng = np.random.RandomState(seed)
    if class_probs is None:
        # skewed prevalence like ICH (reference: preprocess/ICH_process.py:45-46)
        class_probs = np.linspace(0.08, 0.4, n_classes)
    targets = (rng.rand(n, n_classes) < class_probs[None, :]).astype(np.float32)
    # ensure every class has at least 2 positives and 2 negatives
    for c in range(n_classes):
        pos = targets[:, c].sum()
        if pos < 2:
            targets[rng.choice(n, 2, replace=False), c] = 1.0
        if pos > n - 2:
            targets[rng.choice(n, 2, replace=False), c] = 0.0
    # uint8 end-to-end with in-place band updates: the full-image float
    # einsum formulation took ~100s at ImageNet scale (1024×224²)
    images = rng.randint(0, 256, size=(n, image_size, image_size, 3),
                         dtype=np.uint8)
    band = max(2, image_size // n_classes)
    sig = np.uint8(min(255, int(signal)))
    for c in range(n_classes):
        r0 = (c * band) % max(1, image_size - band)
        pos = targets[:, c] == 1
        sl = images[pos, r0 : r0 + band, :, c % 3]
        images[pos, r0 : r0 + band, :, c % 3] = np.where(
            sl > 255 - sig, 255, sl + sig
        )
    return ArrayDataset(images, targets, tuple(f"c{i}" for i in range(n_classes)), name)


# ----------------------------------------------------------------------
# Offline ingest: CSV + PNG directory → packed arrays on disk.
# ----------------------------------------------------------------------

def load_csv_png_dataset(
    csv_path: str,
    image_dir: str,
    class_names: tuple[str, ...],
    image_col: str = "image",
    image_size: int = 224,
    limit: int | None = None,
    name: str = "dataset",
) -> ArrayDataset:
    """Ingest the reference's CSV schema (one-hot label columns and an image
    file column, reference: dataset/all_dataset.py:10-49) into a packed
    dataset: each image decoded once, as RGB, resized bilinearly to
    ``image_size`` square. pandas and PIL are imported here, not with the
    module: the card's machine may lack them."""
    import pandas as pd
    from PIL import Image

    df = pd.read_csv(csv_path)
    if limit is not None:
        df = df.iloc[:limit]
    images = np.zeros((len(df), image_size, image_size, 3), dtype=np.uint8)
    targets = df[list(class_names)].to_numpy().astype(np.float32)
    for i, fname in enumerate(df[image_col].tolist()):
        img = Image.open(os.path.join(image_dir, fname)).convert("RGB")
        img = img.resize((image_size, image_size), Image.BILINEAR)
        images[i] = np.asarray(img, dtype=np.uint8)
    return ArrayDataset(images, targets, tuple(class_names), name)


def save_packed_dataset(ds: ArrayDataset, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "images.npy"), ds.images)
    np.save(os.path.join(out_dir, "targets.npy"), ds.targets)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"class_names": list(ds.class_names), "name": ds.name}, f)


def load_packed_dataset(out_dir: str, mmap: bool = True) -> ArrayDataset:
    """A packed dataset from ``out_dir``; ``mmap`` maps the images instead
    of reading them (the ``Trainer`` copies them to the device once). The
    map is copy-on-write: writable for torch, the file left as it is."""
    images = np.load(os.path.join(out_dir, "images.npy"), mmap_mode="c" if mmap else None)
    targets = np.load(os.path.join(out_dir, "targets.npy"))
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    return ArrayDataset(np.asarray(images), targets, tuple(meta["class_names"]),
                        meta["name"])
