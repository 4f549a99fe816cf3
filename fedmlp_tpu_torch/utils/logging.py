"""Logging and metric output (port of ``fedmlp_tpu/utils/logging.py``).

Reference behavior (utils/utils.py:42-76): an output tree
``<output_dir>/<exp>/{models,logs}``, Python logging to file and stdout, and
a scalar writer. Here the scalars go to a machine-readable JSONL stream,
``logs/metrics.jsonl``, with the JAX package's record format, and to a
tensorboardX event file beside it where tensorboardX is installed."""

from __future__ import annotations

import json
import logging
import os
import random
import sys
import time

import numpy as np
import torch


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
    (MetricWriter, models_dir)."""
    exp_dir = os.path.join(output_dir, exp_tag or "exp")
    models_dir = os.path.join(exp_dir, "models")
    logs_dir = os.path.join(exp_dir, "logs")
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
    directory (the reference's writer, optional as in the JAX package)."""

    def __init__(self, logs_dir: str):
        self.path = os.path.join(logs_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logs_dir)

    def add_scalar(self, tag: str, value, step: int):
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
