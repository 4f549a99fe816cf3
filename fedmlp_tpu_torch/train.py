"""Round-loop trainer (port of ``fedmlp_tpu/train.py``).

The trainer owns the host-side pieces: datasets, partition, label hiding,
batch plans (the JAX package's numpy stream, so the plans are identical),
server-side algorithm state, evaluation cadence. A round trains every client
in turn on one working module (``parallel/fl_runtime.py``).

Precision: parameters and Adam state are float32. With
``compute_dtype='bfloat16'`` the forwards run under bf16 autocast on the
card; on the CPU everything is float32. On the card TF32 is switched OFF for
both matmuls and cuDNN convolutions (``torch.backends.cuda.matmul.
allow_tf32 = torch.backends.cudnn.allow_tf32 = False``), so a float32 run
computes in float32.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from fedmlp_tpu_torch import algos as algo_registry
from fedmlp_tpu_torch import resolve_device
from fedmlp_tpu_torch.config import Config, active_class_lists
from fedmlp_tpu_torch.data.datasets import ArrayDataset, make_synthetic_dataset
from fedmlp_tpu_torch.data.masking import build_hidden_mask
from fedmlp_tpu_torch.data.partition import iid_sampling, non_iid_dirichlet_sampling
from fedmlp_tpu_torch.eval.metrics import multilabel_report
from fedmlp_tpu_torch.fl import fedavg as agg_fedavg
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.parallel import fl_runtime as rt

log = logging.getLogger("fedmlp_tpu_torch")


@dataclass
class RoundRecord:
    round: int
    client_losses: list
    metrics: Optional[dict] = None
    seconds: float = 0.0


@dataclass
class Trainer:
    cfg: Config
    train_ds: Optional[ArrayDataset] = None
    test_ds: Optional[ArrayDataset] = None
    dict_users: Optional[dict] = None
    device: Any = None  # default: cuda (raises without a card)
    history: list = field(default_factory=list)

    def __post_init__(self):
        cfg = self.cfg
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.rng = np.random.RandomState(cfg.seed)
        if self.train_ds is None:
            self.train_ds = make_synthetic_dataset(
                cfg.data.synthetic_train_size, cfg.data.n_classes,
                cfg.data.image_size, seed=cfg.seed,
            )
            self.test_ds = make_synthetic_dataset(
                cfg.data.synthetic_test_size, cfg.data.n_classes,
                cfg.data.image_size, seed=cfg.seed + 1,
            )
        if self.train_ds.n_classes != cfg.data.n_classes:
            raise ValueError(f"dataset has {self.train_ds.n_classes} classes, "
                             f"config {cfg.data.n_classes}")

        # ---- partition (computed afresh; the JAX package's on-disk cache
        # of the same partition is not kept)
        if self.dict_users is None:
            if cfg.algorithm == "centralized" or cfg.n_clients == 1:
                self.dict_users = {0: list(range(len(self.train_ds)))}
            elif cfg.iid:
                self.dict_users = iid_sampling(len(self.train_ds), cfg.n_clients,
                                               cfg.seed)
            else:
                self.dict_users = non_iid_dirichlet_sampling(
                    self.train_ds.targets, cfg.n_classes, 1.0, cfg.n_clients,
                    cfg.seed, cfg.alpha_dirichlet,
                )
        self.n_clients = len(self.dict_users)

        # ---- label hiding (reference: main.py:58-66) ----
        self.hidden = build_hidden_mask(
            self.train_ds.targets, cfg.p_pos, np.random.RandomState(cfg.seed)
        )
        self.active_lists = active_class_lists(cfg)[: self.n_clients]

        self.fd = rt.build_federated_data(
            self.train_ds.images, self.train_ds.targets, self.dict_users,
            self.hidden, self.active_lists, device=self.device,
        )
        self.dict_len = self.fd.n_local.cpu().numpy()

        # ---- model: one working module trains every client in turn; a
        # second holds the frozen global model for NEEDS_GLOBAL algorithms
        self.model = init_model(build_model(cfg.model, cfg.n_classes),
                                cfg.seed).to(self.device)
        self.global_vars = {n: v.detach().clone()
                            for n, v in self.model.state_dict().items()}

        # ---- algorithm ----
        self.algo = algo_registry.get_algorithm(cfg.algorithm)
        self.global_model = None
        if self.algo.NEEDS_GLOBAL or cfg.fedmlp.stage2_distill:
            self.global_model = build_model(cfg.model, cfg.n_classes).to(self.device)
            self.global_model.requires_grad_(False)
        self.round_fn = rt.make_local_round(
            self.model, self.algo.loss_fn,
            lr=cfg.base_lr, batch_size=cfg.batch_size,
            mean=cfg.data.mean, std=cfg.data.std,
            view_mode=self.algo.VIEW_MODE, needs_global=self.algo.NEEDS_GLOBAL,
            augment_backend=cfg.data.augment_backend,
            compute_dtype=cfg.compute_dtype, global_model=self.global_model,
        )
        self.server_state = (
            self.algo.init_server_state(self)
            if hasattr(self.algo, "init_server_state") else {}
        )
        self.eval_probs = rt.make_eval_fn(
            self.model, cfg.data.mean, cfg.data.std,
            batch_size=cfg.batch_size * 4, compute_dtype=cfg.compute_dtype,
        )
        # augmentation, dropout and stochastic-depth draws
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    # ------------------------------------------------------------------
    def client_ctx(self) -> dict:
        """Per-client context [K, C] that the loss functions read: the
        annotated (active) and missing (negative) class masks."""
        active_f = self.fd.active.float()
        return {"active": active_f, "negative": 1.0 - active_f}

    def local_pass(self, round_fn, sample_arrays: dict, scalars: dict):
        """One local-training pass for all clients with fresh batch plans;
        returns (state, mean_losses [K])."""
        cfg = self.cfg
        pos, pos_valid, _ = rt.make_batch_plan(
            self.rng, self.fd.valid.cpu().numpy(), cfg.batch_size, cfg.local_ep)
        data = {"images": self.fd.images, "idx": self.fd.idx,
                "ctx": self.client_ctx()}
        plan = {"pos": pos, "pos_valid": pos_valid, "sample": sample_arrays}
        return round_fn(self.global_vars, data, plan, scalars, self.generator)

    def aggregate(self, svars: dict, weights) -> dict:
        """Dataset-size-weighted FedAvg over the client-stacked variables."""
        return agg_fedavg(svars, weights)

    def broadcast(self, global_vars: dict) -> dict:
        return rt.broadcast_to_clients(global_vars, self.n_clients)

    def round_scalars(self, rnd: int) -> dict:
        return {"rnd": float(rnd)}

    # ------------------------------------------------------------------
    def run_round(self, rnd: int) -> RoundRecord:
        cfg = self.cfg
        t0 = time.time()
        losses = self.algo.custom_round(self, rnd)
        rec = RoundRecord(rnd, losses.cpu().numpy().tolist(), None, time.time() - t0)
        if (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds_warmup - 1:
            rec.metrics = self.evaluate()
            log.info("round %d metrics: %s", rnd, rec.metrics)
        self.history.append(rec)
        return rec

    def evaluate(self) -> dict:
        probs = self.eval_probs(self.global_vars, self.test_ds.images)
        return multilabel_report(self.test_ds.targets, probs)

    def run(self, rounds: Optional[int] = None) -> list:
        rounds = rounds if rounds is not None else self.cfg.rounds_warmup
        for rnd in range(rounds):
            rec = self.run_round(rnd)
            log.info("round %d done in %.2fs, losses %s", rnd, rec.seconds,
                     np.round(rec.client_losses, 4))
        return self.history
