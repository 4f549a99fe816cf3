"""Round-loop trainer (port of ``fedmlp_tpu/train.py``).

The trainer owns the host-side pieces: datasets, partition, label hiding,
batch plans (the JAX package's numpy stream, so the plans are identical),
server-side algorithm state, evaluation cadence. A round runs on one of
three engines (``parallel/fl_runtime.py``, ``engine_of``): the per-client
loop, which trains every client in turn on one working module; the lockstep
order (``batched_global='on'``), steps outside and clients inside; and the
channel-stacked clients (``client_stacking='on'``, ``models/stacked.py``).

The training images live on the device, or with ``data.host_stream`` stay in
the packed ``images.npy`` on disk and reach each round through a
``PackLoader`` (``data/native_loader.py``): the whole round at once, or with
``data.stream_window=W`` in windows of W steps (``parallel/streaming.py``).

Inside a process group (``torchrun``, or ``parallel.mesh.launch``) the
trainer builds a mesh over the world (``parallel/mesh.py``; ``use_mesh``, as
the JAX ``Trainer``): C = world / ``mesh.data_axis`` client shards each train
their block of the clients, the round's outputs are gathered on every rank,
and everything after the round (aggregation, server state, evaluation, the
host generator) runs the same on every rank. Only rank 0 writes files.

Precision: parameters and Adam state are float32. With
``compute_dtype='bfloat16'`` the forwards run under bf16 autocast on the
card; on the CPU everything is float32. On the card TF32 is switched OFF for
both matmuls and cuDNN convolutions (``torch.backends.cuda.matmul.
allow_tf32 = torch.backends.cudnn.allow_tf32 = False``), so a float32 run
computes in float32.
"""

from __future__ import annotations

import logging
import os
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
from fedmlp_tpu_torch.models import build_model, init_model, load_pretrained
from fedmlp_tpu_torch.models.efficientnet import DW_BACKENDS
from fedmlp_tpu_torch.models.factory import is_ported as model_is_ported
from fedmlp_tpu_torch.ops.augment import AUGMENT_BACKENDS
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.parallel.mesh import make_mesh, process_rank, world_size
from fedmlp_tpu_torch.parallel.streaming import RoundStream
from fedmlp_tpu_torch.utils import profiling as trace

log = logging.getLogger("fedmlp_tpu_torch")


class UnportedConfigError(ValueError):
    """A ``Config`` value asks for something the port does not run."""


ENGINE_MODES = ("auto", "on", "off")


def engine_of(cfg: Config) -> str:
    """The round engine ``cfg`` selects: 'stacked' (``client_stacking='on'``),
    'lockstep' (``batched_global='on'``) or 'mapped', the per-client loop.
    'auto' is off for both: the JAX package turns them on only on a TPU
    (``fedmlp_tpu/train.py:333-425``)."""
    if cfg.client_stacking == "on":
        return "stacked"
    return "lockstep" if cfg.batched_global == "on" else "mapped"


def check_ported(cfg: Config, world: Optional[int] = None) -> None:
    """Raise :class:`UnportedConfigError`, naming the field, for every
    ``Config`` value that selects an algorithm, model, backend or engine of
    the JAX package that the port has not got, and for every engine
    combination that the port refuses. 'auto' and empty values resolve to
    what the port does: the per-client loop engine, separate forwards per
    view, views made in the step, device-resident data, grouped-conv
    depthwise. Every ``dw_backend`` of the JAX package, ``remat``,
    ``remat_stages``, ``weight_stream``, ``data.host_stream`` and
    ``data.stream_window`` run as there; left is ``param_dtype`` (float32
    only; the JAX package reads it nowhere). The mesh is checked against a
    world of ``world`` processes (default: the process group's, 1 outside
    one; ``_mesh_refusals``: what JAX refuses, and ``hoist_augment`` over
    data shards, which JAX drops). ``scan_unroll``, ``client_unroll``,
    ``small_pack`` and, where no lockstep engine runs the one-forward loss,
    ``view_precat`` only shape the JAX package's XLA program and are the
    identity here."""
    bad = []

    def need(ok: bool, field_name: str, value, have: str) -> None:
        if not ok:
            bad.append(f"{field_name}={value!r} is not ported ({have})")

    need(cfg.algorithm in algo_registry.registered(), "algorithm", cfg.algorithm,
         f"have {algo_registry.registered()}")
    need(model_is_ported(cfg.model), "model", cfg.model,
         "have the JAX registry's names and aliases")
    need(cfg.dw_backend in ("",) + DW_BACKENDS, "dw_backend", cfg.dw_backend,
         f"have '' and {DW_BACKENDS}")
    for name in ("client_stacking", "batched_global", "view_precat"):
        need(getattr(cfg, name) in ENGINE_MODES, name, getattr(cfg, name),
             f"have {ENGINE_MODES}")
    need(cfg.param_dtype == "float32", "param_dtype", cfg.param_dtype,
         "parameters are float32")
    need(cfg.compute_dtype in ("float32", "bfloat16"), "compute_dtype",
         cfg.compute_dtype, "have float32 and bfloat16")
    need(cfg.data.stream_window >= 0, "data.stream_window", cfg.data.stream_window,
         "a window is a count of steps, 0 for none")
    window = cfg.data.stream_window
    if window > 0 and not cfg.data.host_stream:
        # the JAX Config ignores the window there; no knob is accepted to be ignored
        bad.append(f"data.stream_window={window} with data.host_stream=False is "
                   "refused: windows stream the round from the packed shard")
    if window > 0 and cfg.pre_augment > 0:
        # as the JAX package (fedmlp_tpu/train.py:384-387)
        bad.append(f"data.stream_window={window} with pre_augment={cfg.pre_augment} "
                   "is refused: views made before the round need the whole round, "
                   "a window holds W steps")
    if window > 0 and cfg.hoist_augment:
        # JAX hoists each window with one key, so its windowed hoisted round is
        # not its unwindowed one (ROADMAP.md §C)
        bad.append(f"data.stream_window={window} with hoist_augment="
                   f"{cfg.hoist_augment} is refused: a hoisted round makes the whole "
                   "round's views before its first step, a window holds W steps")
    need(cfg.data.augment_backend in AUGMENT_BACKENDS,
         "data.augment_backend", cfg.data.augment_backend,
         f"have {AUGMENT_BACKENDS}")
    if cfg.algorithm == "fedmlp" and cfg.fedmlp.stage2_distill and cfg.pre_augment > 0:
        # the pre-made views are the algorithm's two ('x1', 'x2'); the stage-2
        # distillation term reads the single view's frozen-global logits,
        # where the JAX package fails (fedmlp_tpu/parallel/fl_runtime.py:547-549)
        bad.append(f"fedmlp.stage2_distill=True with pre_augment={cfg.pre_augment} "
                   "is refused: stage 2's distillation needs its single view, and "
                   "pre-made views are the algorithm's two")
    if cfg.algorithm in algo_registry.registered() and model_is_ported(cfg.model):
        bad += _engine_refusals(cfg)
        bad += _mesh_refusals(cfg, world_size() if world is None else world)
    if bad:
        raise UnportedConfigError("; ".join(bad))


def _engine_refusals(cfg: Config) -> list:
    """What ``client_stacking='on'`` or ``batched_global='on'`` cannot run
    (the JAX package's refusals, ``fedmlp_tpu/train.py:313-383``, and one of
    the port's own: no knob is accepted and then ignored)."""
    from fedmlp_tpu_torch.models.stacked import supports_stacking

    algo = algo_registry.get_algorithm(cfg.algorithm)
    stacked = cfg.client_stacking == "on"
    lockstep = cfg.batched_global == "on"
    bad = []
    if stacked and lockstep:
        bad.append("client_stacking='on' with batched_global='on' is refused: "
                   "choose one engine")
    if stacked and not hasattr(algo, "stacked_loss_fn"):
        bad.append(f"client_stacking='on' is refused: algorithm {cfg.algorithm!r} "
                   "has no stacked loss (have fedavg, centralized, fedmlp)")
    if stacked and not supports_stacking(build_model(cfg.model, cfg.n_classes,
                                                     image_size=cfg.data.image_size)):
        bad.append(f"client_stacking='on' is refused: model {cfg.model!r} has no "
                   "stacked forward (have smallcnn and efficient_b0..b7)")
    if stacked and cfg.data.host_stream:
        bad.append("client_stacking='on' with data.host_stream=True is refused: "
                   "the stacked engine has no windowed carry")
    if stacked and cfg.view_concat == "on" and hasattr(algo, "loss_fn_viewcat"):
        bad.append("view_concat='on' with client_stacking='on' is refused: the "
                   "stacked engine runs the algorithm's two forwards")
    if lockstep and not algo.NEEDS_GLOBAL:
        bad.append(f"batched_global='on' is refused: algorithm {cfg.algorithm!r} "
                   "does not need the global model (have fedmlp, fednoro)")
    if (stacked or lockstep) and cfg.pre_augment > 0:
        bad.append(f"pre_augment={cfg.pre_augment} with "
                   f"{'client_stacking' if stacked else 'batched_global'}='on' is "
                   "refused: that engine makes its views in the step")
    return bad


def _mesh_refusals(cfg: Config, world: int) -> list:
    """What a mesh of world / D client shards × D = ``mesh.data_axis`` data
    shards cannot run: the JAX package's refusals (``fedmlp_tpu/train.py:
    313-332``, ``:341-366``, ``:400-415``), and where it degrades silently
    the port's own (no knob is accepted and then ignored). Views made before
    the round and, on the client axis alone, ``hoist_augment`` run sharded;
    a ``batch_size`` that D does not divide runs the rounds unsharded
    (``Trainer.round_mesh``), as in JAX."""
    m = cfg.mesh
    D = max(1, m.data_axis)
    C = max(1, world // D)
    bad = []
    if m.client_axis != -1:
        bad.append(f"mesh.client_axis={m.client_axis} is refused: the client axis "
                   "takes the processes the data axis leaves (the JAX package never "
                   "reads it); leave it -1")
    if C * D != world:
        bad.append(f"mesh.data_axis={m.data_axis} is refused: the mesh needs "
                   f"{C * D} processes, the world has {world}")
    if D > 1:
        if hasattr(algo_registry.get_algorithm(cfg.algorithm), "post_step"):
            bad.append(f"algorithm={cfg.algorithm!r} with mesh.data_axis={D} is refused: "
                       "its per-client state (post_step) would differ between data "
                       "shards")
        if cfg.batched_global == "on":
            bad.append(f"batched_global='on' with mesh.data_axis={D} is refused: the "
                       "lockstep engine has no data-parallel path")
    if C * D > 1:
        if cfg.client_stacking == "on":
            bad.append(f"client_stacking='on' with a mesh of {C} client x "
                       f"{D} data shards (mesh.data_axis={m.data_axis}) is refused: "
                       "the stacked engine runs on one process")
    if D > 1 and cfg.hoist_augment and cfg.batch_size % D == 0:
        # where the data shards split the batch, JAX turns the hoist off
        # without a word (fedmlp_tpu/parallel/fl_runtime.py:723); no knob is
        # accepted and then ignored. An undivided batch runs unsharded, the
        # hoist included, as in JAX
        bad.append(f"hoist_augment={cfg.hoist_augment} with mesh.data_axis={D} is "
                   "refused: the JAX package drops the hoist over data shards")
    return bad


def partition_cache_path(cfg: Config, train_ds: ArrayDataset) -> Optional[str]:
    """``<output_dir>/{iid,non-iid}-dictusers/<tag>.npy``, the file the JAX
    package's ``Trainer`` reads and writes (a pickled dict through
    ``np.save``), or None without an output directory. The tag holds the
    dataset's name and size, the seed, the client count and, non-iid, the
    Dirichlet alpha."""
    if not cfg.output_dir:
        return None
    tag = (f"{train_ds.name}_{len(train_ds)}_{cfg.seed}_{cfg.n_clients}"
           + ("" if cfg.iid else f"_{cfg.alpha_dirichlet}"))
    sub = "iid-dictusers" if cfg.iid else "non-iid-dictusers"
    return os.path.join(cfg.output_dir, sub, tag + ".npy")


@dataclass
class RoundRecord:
    round: int
    client_losses: list
    metrics: Optional[dict] = None
    seconds: float = 0.0  # the round span's host seconds
    spans: Optional[dict] = None  # the round's record (utils/profiling.round_record)


@dataclass
class Trainer:
    cfg: Config
    train_ds: Optional[ArrayDataset] = None
    test_ds: Optional[ArrayDataset] = None
    dict_users: Optional[dict] = None
    device: Any = None  # default: cuda (raises without a card)
    use_mesh: bool = True  # inside a process group, shard over its processes
    images_npy: Optional[str] = None  # packed shard for host_stream
    history: list = field(default_factory=list)

    def __post_init__(self):
        with trace.span(trace.TRAINER_INIT) as init:
            self._build()
        log.info("trainer set up in %.2fs", init.ns / 1e9)

    def _build(self):
        cfg = self.cfg
        check_ported(cfg, world_size() if self.use_mesh else 1)
        npy = None
        if cfg.data.host_stream:
            npy = self.images_npy or (cfg.data.root
                                      and os.path.join(cfg.data.root, "train", "images.npy"))
            if not npy or not os.path.exists(npy):
                raise UnportedConfigError(
                    "data.host_stream=True without a shard: host_stream requires a "
                    "packed images.npy (data.root or Trainer(images_npy=...))")
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.mesh = (make_mesh(data_shards=max(1, cfg.mesh.data_axis), device=self.device)
                     if self.use_mesh else None)
        if self.mesh is not None and cfg.batch_size % self.mesh.data_shards:
            log.warning("mesh: batch_size=%d does not split over mesh.data_axis=%d data "
                        "shards: every rank runs the whole round, unsharded (as the JAX "
                        "package)", cfg.batch_size, self.mesh.data_shards)
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

        # ---- partition, with the JAX package's on-disk cache: the same
        # file (reference: dataset/dataset.py:168-180), so two runs over one
        # output directory train on one partition, whichever package runs
        if self.dict_users is None:
            cache = partition_cache_path(cfg, self.train_ds)
            if cfg.algorithm == "centralized" or cfg.n_clients == 1:
                self.dict_users = {0: list(range(len(self.train_ds)))}
            elif cache and os.path.exists(cache):
                self.dict_users = np.load(cache, allow_pickle=True).item()
            else:
                if cfg.iid:
                    self.dict_users = iid_sampling(len(self.train_ds), cfg.n_clients,
                                                   cfg.seed)
                else:
                    self.dict_users = non_iid_dirichlet_sampling(
                        self.train_ds.targets, cfg.n_classes, 1.0, cfg.n_clients,
                        cfg.seed, cfg.alpha_dirichlet,
                    )
                if cache and process_rank() == 0:
                    # whole or not at all: another rank or run may read it
                    os.makedirs(os.path.dirname(cache), exist_ok=True)
                    part = f"{cache}.{os.getpid()}.npy"
                    np.save(part, self.dict_users, allow_pickle=True)
                    os.replace(part, cache)
        self.n_clients = len(self.dict_users)

        # ---- label hiding (reference: main.py:58-66) ----
        self.hidden = build_hidden_mask(
            self.train_ds.targets, cfg.p_pos, np.random.RandomState(cfg.seed)
        )
        if cfg.algorithm == "centralized":  # one client sees every label
            self.active_lists = [list(range(cfg.n_classes))]
            self.hidden[:] = False
        else:
            self.active_lists = active_class_lists(cfg)[: self.n_clients]

        # ---- host streaming: the images stay in the shard on disk. Reused
        # (pinned) output buffers only on the card: on the CPU a tensor
        # wraps the loader's array, as JAX's CPU backend aliases it
        self.loader = None
        if npy:
            from fedmlp_tpu_torch.data.native_loader import PackLoader

            self.loader = PackLoader(npy, reuse_buffers=self.device.type == "cuda")
            if self.loader.shape != self.train_ds.images.shape:
                raise ValueError(f"{npy} holds images {self.loader.shape}, the training "
                                 f"set {self.train_ds.images.shape}")
        self.fd = rt.build_federated_data(
            self.train_ds.images, self.train_ds.targets, self.dict_users,
            self.hidden, self.active_lists, device=self.device,
            device_images=self.loader is None,
        )
        self._idx_host = self.fd.idx.cpu().numpy()
        self.stream_peak_rows = 0  # most image rows a streamed round held at once
        self.dict_len = self.fd.n_local.cpu().numpy()

        # ---- model: one working module trains every client in turn; a
        # second holds the frozen global model for NEEDS_GLOBAL algorithms,
        # a third the EMA teacher for NEEDS_TEACHER ones
        self.model = init_model(self._build_model(), cfg.seed)
        if cfg.pretrained_path:
            n_loaded, _missing = load_pretrained(self.model, cfg.pretrained_path)
            log.info("loaded %d pretrained arrays from %s", n_loaded,
                     cfg.pretrained_path)
        self.model.to(self.device)
        self.global_vars = {n: v.detach().clone()
                            for n, v in self.model.state_dict().items()}

        # ---- algorithm and engine ----
        # the per-client loop's steps read each parameter rounded to bf16
        # (JAX's weight streaming); off in float32, as there
        self.weight_stream_dtype = (torch.bfloat16 if cfg.weight_stream
                                    and cfg.compute_dtype == "bfloat16" else None)
        self.algo = algo_registry.get_algorithm(cfg.algorithm)
        self.global_model = (self._frozen_twin()
                             if self.algo.NEEDS_GLOBAL or cfg.fedmlp.stage2_distill
                             else None)
        self.teacher_model = (self._frozen_twin()
                              if getattr(self.algo, "NEEDS_TEACHER", False) else None)
        self.engine = engine_of(cfg)
        log.info("engine: %s", {
            "stacked": "channel-stacked lockstep clients",
            "lockstep": "lockstep clients (K·B-batched views and frozen-global forwards)",
            "mapped": "per-client loop"}[self.engine])
        if self.engine == "lockstep" and cfg.hoist_augment:
            log.warning("engine: hoist_augment=%d does not reach the lockstep engine, "
                        "which makes each step's views in the step (as the JAX "
                        "package's)", cfg.hoist_augment)
        # knobs that the JAX package never hands to these engines
        if self.engine == "stacked" and cfg.dw_backend not in ("", "conv"):
            log.warning("engine: dw_backend=%r does not reach the stacked forward, "
                        "which runs grouped convolutions (as the JAX package's)",
                        cfg.dw_backend)
        if self.engine == "stacked" and (cfg.remat or cfg.remat_stages):
            log.warning("engine: remat=%d remat_stages=%r do not reach the stacked "
                        "forward, which rematerializes nothing (as the JAX "
                        "package's)", cfg.remat, cfg.remat_stages)
        if self.engine != "mapped" and cfg.weight_stream:
            log.warning("engine: weight_stream=%d does not reach the %s engine's "
                        "step (as in the JAX package)", cfg.weight_stream, self.engine)
        # 'auto' is off: the JAX package turns it on only on a TPU
        # (fedmlp_tpu/train.py:200-211)
        loss_fn = self.algo.loss_fn
        if cfg.view_concat == "on" and hasattr(self.algo, "loss_fn_viewcat"):
            loss_fn = self.algo.loss_fn_viewcat
            log.info("engine: dual views concatenated into one 2B forward")
        self._pre_augment_chunk = self._resolve_pre_augment(cfg)
        self.round_fn = self.make_round(
            loss_fn, getattr(self.algo, "stacked_loss_fn", None),
            view_mode=self.algo.VIEW_MODE, needs_global=self.algo.NEEDS_GLOBAL,
            view_precat=(cfg.view_precat == "on"
                         and loss_fn is getattr(self.algo, "loss_fn_viewcat", None)))
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
        self.iter_num = 0  # lifetime local-step counter (reference iter_num)

    def make_round(self, loss_fn, stacked_loss_fn=None, *, view_mode: str,
                   needs_global: bool, view_precat: bool = False):
        """A round function on this trainer's engine: ``stacked_loss_fn`` on
        the stacked engine, ``loss_fn`` on the others."""
        cfg = self.cfg
        kw = dict(lr=cfg.base_lr, batch_size=cfg.batch_size, mean=cfg.data.mean,
                  std=cfg.data.std, view_mode=view_mode, needs_global=needs_global,
                  augment_backend=cfg.data.augment_backend,
                  compute_dtype=cfg.compute_dtype, global_model=self.global_model)
        if self.engine == "stacked":
            return rt.make_stacked_local_round(self.model, stacked_loss_fn,
                                               hoist_augment=bool(cfg.hoist_augment), **kw)
        if self.engine == "lockstep":
            return rt.make_lockstep_local_round(self.model, loss_fn, view_precat=view_precat,
                                                mesh=self.round_mesh, **kw)
        return rt.make_local_round(self.model, loss_fn,
                                   hoist_augment=bool(cfg.hoist_augment),
                                   weight_stream_dtype=self.weight_stream_dtype,
                                   mesh=self.round_mesh, **kw)

    @property
    def round_mesh(self):
        """The mesh the rounds shard over, or None on one process and when
        the data shards do not divide ``batch_size``: then every rank runs
        the whole round, as a run without a mesh (the JAX ``Trainer``'s
        ``round_mesh``)."""
        m = self.mesh
        if m is None or m.size == 1 or self.cfg.batch_size % m.data_shards:
            return None
        return m

    def _build_model(self):
        """An uninitialized module of ``cfg.model``: the one place the
        Trainer builds the working, frozen-global and teacher modules.
        ``remat_stages`` is parsed as the JAX ``Trainer`` does: a comma list
        of integers (a non-integer raises)."""
        cfg = self.cfg
        stages = (tuple(int(s) for s in cfg.remat_stages.split(",") if s.strip())
                  if cfg.remat_stages else ())
        return build_model(cfg.model, cfg.n_classes, dw_backend=cfg.dw_backend or None,
                           image_size=cfg.data.image_size, remat=bool(cfg.remat),
                           remat_stages=stages)

    @staticmethod
    def _resolve_pre_augment(cfg: Config) -> int:
        """Chunk size of the views made before each round (0: made in the
        step). ``pre_augment`` > 0 gives it; -1 (auto) resolves to 0. The
        JAX package's auto engages only on a TPU, to dodge a fault of its
        worker (``fedmlp_tpu/train.py:369-398``); the card has no such
        fault."""
        return max(int(cfg.pre_augment), 0)

    def _frozen_twin(self):
        """A module of the model's architecture that takes no gradients."""
        return self._build_model().to(self.device).requires_grad_(False)

    # ------------------------------------------------------------------
    def client_ctx(self) -> dict:
        """Per-client context (leading axis K) that the loss functions
        read: the annotated (active) and missing (negative) class masks,
        the positive-class weights, class counts and dataset sizes, plus
        whatever the algorithm's ``extra_ctx`` hook adds."""
        fd = self.fd
        active_f = fd.active.float()
        # loss_w_unknown: 1 everywhere except active classes (reference:
        # utils/local_training.py:41-42)
        ctx = {
            "active": active_f,
            "negative": 1.0 - active_f,
            "loss_w": fd.loss_w,
            "loss_w_unknown": active_f * fd.loss_w + (1.0 - active_f),
            "class_num": fd.class_num,
            "n_local": fd.n_local.float(),
        }
        if hasattr(self.algo, "extra_ctx"):
            ctx.update(self.algo.extra_ctx(self))
        return ctx

    def apply_corrections(self, corr: dict) -> int:
        """Label corrections into the observed-label table: the reference's
        DatasetSplit ``corr_idx`` (utils/local_training.py:1352-1355). For
        the samples listed under (client, missing class) the observed label
        becomes positive; an annotated class of that client is left as it
        is. ``corr`` maps client → {class → GLOBAL sample indices}. Returns
        the number of cells that flipped."""
        obs = self.fd.obs_targets.cpu().numpy().copy()
        idx = self.fd.idx.cpu().numpy()
        valid = self.fd.valid.cpu().numpy()
        active = self.fd.active.cpu().numpy()
        flipped = 0
        for k, per_class in corr.items():
            for c, gidxs in per_class.items():
                if active[k, c]:
                    continue  # the reference corrects only missing classes
                rows = np.isin(idx[k], np.asarray(list(gidxs))) & valid[k]
                flipped += int((obs[k, rows, c] != 1.0).sum())
                obs[k, rows, c] = 1.0
        self.fd.obs_targets = torch.as_tensor(obs, device=self.device)
        return flipped

    def local_pass(self, round_fn, sample_arrays: dict, scalars: dict,
                   extra_state: Optional[dict] = None):
        """One local-training pass for all clients with fresh batch plans;
        returns (state, mean_losses [K], aux sums {name: [K, ...]}).
        ``extra_state`` may carry 'teacher'/'cstate' entries for algorithms
        that persist them; ``state`` then holds their new values. With
        ``pre_augment`` the round's views (the algorithm's ``VIEW_MODE``)
        are made before the round, ``pre_augment`` images at a time. With
        ``host_stream`` the round's images come from the loader
        (``RoundStream``: at once, or in windows of ``stream_window``
        steps). Under a mesh the rank streams, and makes views of, only its
        clients' rows of its data shard."""
        with trace.span(trace.LOCAL_PASS, self.device):
            cfg = self.cfg
            pos, pos_valid, _ = rt.make_batch_plan(
                self.rng, self.fd.valid.cpu().numpy(), cfg.batch_size, cfg.local_ep)
            # the rank's clients and rows: what it streams and makes views of
            mine, rows, place = slice(None), slice(None), None
            if self.round_mesh is not None:
                place = self.round_mesh.place(self.n_clients, cfg.batch_size)
                mine, rows = slice(place.clients.start, place.clients.stop), place.rows
            images = self.fd.images
            if self.loader is not None:
                gidx = self._idx_host[np.arange(self.n_clients)[None, :, None], pos]
                images = RoundStream(self.loader, gidx[:, mine, rows], pos_valid[:, mine],
                                     cfg.data.stream_window, self.device)
            data = {"images": images, "idx": self.fd.idx, "ctx": self.client_ctx()}
            plan = {"pos": pos, "pos_valid": pos_valid, "sample": sample_arrays,
                    "iter0": self.iter_num}
            if self._pre_augment_chunk:
                # the draws of the whole round's views, the same on every rank,
                # come off the generator before the round's K client seeds
                # (rt.client_generators); a rank makes its block's views
                own = (images.open("client").whole() if self.loader is not None
                       else rt.gather_round_images(images, self.fd.idx[mine],
                                                   pos[:, mine, rows]))
                plan["views"] = rt.pre_augment_views(
                    own, self.generator, view_mode=self.algo.VIEW_MODE,
                    augment_backend=cfg.data.augment_backend, mean=cfg.data.mean,
                    std=cfg.data.std, chunk=self._pre_augment_chunk, place=place)
            out = round_fn(self.global_vars, data, plan, scalars, self.generator,
                           extra_state)
            if self.loader is not None:
                self.stream_peak_rows = max(self.stream_peak_rows, images.peak_rows)
            self.iter_num += pos.shape[0]
            return out

    def aggregate(self, svars: dict, weights) -> dict:
        """Dataset-size-weighted FedAvg over the client-stacked variables."""
        with trace.span(trace.AGGREGATE, self.device):
            return agg_fedavg(svars, weights)

    def broadcast(self, global_vars: dict) -> dict:
        return rt.broadcast_to_clients(global_vars, self.n_clients)

    def round_scalars(self, rnd: int) -> dict:
        base = {"rnd": float(rnd)}
        if hasattr(self.algo, "round_scalars"):
            base.update(self.algo.round_scalars(self, rnd))
        return base

    # ------------------------------------------------------------------
    def run_round(self, rnd: int) -> RoundRecord:
        """One round, with its record of spans and counters
        (``utils/profiling.py``): the round span up to and including the
        read of the losses (``RoundRecord.seconds``), then the evaluation
        when it is due."""
        cfg = self.cfg
        with trace.round_record(rnd) as spans:
            with trace.span(trace.ROUND) as whole:
                if hasattr(self.algo, "custom_round"):
                    losses = self.algo.custom_round(self, rnd)
                else:
                    state, losses, _ = self.local_pass(
                        self.round_fn, {"labels": self.fd.obs_targets},
                        self.round_scalars(rnd))
                    # server aggregation (an algorithm may override it)
                    if hasattr(self.algo, "server_update"):
                        self.global_vars, self.server_state = self.algo.server_update(
                            self, rnd, state["vars"], self.server_state)
                    else:
                        self.global_vars = self.aggregate(state["vars"], self.dict_len)
                losses = losses.cpu().numpy().tolist()
            rec = RoundRecord(rnd, losses, None, whole.ns / 1e9, spans)
            if (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds_warmup - 1:
                rec.metrics = self.evaluate()
                log.info("round %d metrics: %s", rnd, rec.metrics)
        self.history.append(rec)
        return rec

    def evaluate(self) -> dict:
        with trace.span(trace.EVALUATE):
            probs = self.eval_probs(self.global_vars, self.test_ds.images)
            return multilabel_report(self.test_ds.targets, probs)

    def run(self, rounds: Optional[int] = None) -> list:
        rounds = rounds if rounds is not None else self.cfg.rounds_warmup
        for rnd in range(rounds):
            rec = self.run_round(rnd)
            log.info("round %d done in %.2fs, losses %s; %s", rnd, rec.seconds,
                     np.round(rec.client_losses, 4), trace.round_summary(rec.spans))
        return self.history
