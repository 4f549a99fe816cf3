"""What the benchmark's tests share: a cell cut to a size the CPU runs in
seconds (the same model and traffic, fewer clients, images and pixels)."""

import time

import torch

from fedbench import cell as C
from fedbench import harness

TINY = dict(image_size=64, n_clients=2, train_images_per_client=16, batch_size=8)
SEED = 2**31 + 77  # past 32 signed bits, as a benchmark run's seed may be


def tiny_cell(name: str) -> C.Cell:
    cell = C.load_cell(name)
    cell.config.update(TINY)
    return cell


def run_tiny(name: str, patch=None, traced: bool = False) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(tiny_cell(name), SEED, 0.0, traced, "cpu", time.perf_counter(),
                            metrics=[("mfu", "%"), ("algo_share_pct", "%")], patch=patch)
