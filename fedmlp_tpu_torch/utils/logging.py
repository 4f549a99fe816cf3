"""Logging and metric output (port of ``fedmlp_tpu/utils/logging.py``).

Reference behavior (utils/utils.py:42-76): an output tree
``<output_dir>/<exp>/{models,logs}``, Python logging to file and stdout, and
a scalar writer. Here the scalars go to a machine-readable JSONL stream,
``logs/metrics.jsonl``, with the JAX package's record format, and to a
tensorboardX event file beside it where tensorboardX is installed. In a
group of processes only rank 0 writes them; the others log warnings to
stdout."""

from __future__ import annotations

import json
import logging
import os
import random
import sys
import time

import numpy as np
import torch

from fedmlp_tpu_torch.parallel.mesh import process_rank


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (reference:
    utils/utils.py:12-17). The trainer's own streams are seeded from the
    config on their own."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def set_output_files(output_dir: str, exp_tag: str):
    """Create the output tree and configure logging to ``logs/logs.txt``
    and stdout (replacing the handlers of an earlier call). Returns
    (MetricWriter, models_dir). A rank other than 0 creates nothing, logs
    warnings to stdout and gets a writer that writes nothing."""
    exp_dir = os.path.join(output_dir, exp_tag or "exp")
    models_dir = os.path.join(exp_dir, "models")
    logs_dir = os.path.join(exp_dir, "logs")
    rank = process_rank()
    if rank:
        logging.basicConfig(level=logging.WARNING, format=f"[rank {rank}] %(message)s",
                            handlers=[logging.StreamHandler(sys.stdout)], force=True)
        return MetricWriter(None), models_dir
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(logs_dir, exist_ok=True)

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S",
        handlers=[logging.FileHandler(os.path.join(logs_dir, "logs.txt")),
                  logging.StreamHandler(sys.stdout)],
        force=True,
    )
    return MetricWriter(logs_dir), models_dir


class MetricWriter:
    """JSONL scalar stream: one ``{"tag", "value", "step", "time"}`` record
    a line, appended and flushed as it is written; and, where tensorboardX
    imports, the same scalars through its ``SummaryWriter`` into the same
    directory (the reference's writer, optional as in the JAX package).
    ``logs_dir`` None: a writer that writes nothing (ranks other than 0)."""

    def __init__(self, logs_dir: str | None):
        self.path = logs_dir and os.path.join(logs_dir, "metrics.jsonl")
        self._fh = self._tb = None
        if logs_dir is None:
            return
        self._fh = open(self.path, "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logs_dir)

    def add_scalar(self, tag: str, value, step: int):
        if self._fh is None:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
