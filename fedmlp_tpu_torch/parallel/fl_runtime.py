"""Federated-learning runtime: federation tables, batch plans, the per-client
local round, the feature harvest and the evaluation forward.

The JAX package compiles a round into one program over client-stacked
state; here a round is a Python loop, on one of three engines:
``make_local_round`` trains the clients in turn on one working module (the
JAX package's mapped engine, ``lax.map`` over clients and ``lax.scan`` over
steps written out); ``make_lockstep_local_round`` runs the steps outside and
the clients inside; ``make_stacked_local_round`` runs all clients as one
channel-stacked network (``models/stacked.py``).

Under a ``Mesh`` (``parallel/mesh.py``; the JAX package's ``shard_map``
over its ``client`` and ``data`` axes) a rank runs the clients of its block
of the client axis (``_local_part``) and gathers the round's outputs into
the whole [K, ...] on every rank, so everything after the round runs
replicated. Client k then draws from a generator of its own, seeded from
the k-th of K draws of the round's generator (``client_generators``; JAX's
``split(key, K)``), so the round does not depend on which rank runs k. The
per-client loop also splits each step's batch over the data shards.

Parity notes (as in the JAX package):
  * Adam is created afresh for every client every round (the reference
    constructs a new torch.optim.Adam per call, utils/local_training.py:
    912-913), with L2 weight decay added to the gradient.
  * Losses divide by the CONFIGURED batch size: a ragged last batch is
    filled with the client's first sample, masked out of the loss, yet
    still part of the batch-norm statistics, exactly as there.
  * A step with no valid sample is skipped: params, batch-norm statistics
    and the Adam moments and count all stay as they were.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
from torch.optim.adam import adam as _adam

from fedmlp_tpu_torch.data.masking import (
    build_active_matrix,
    build_client_index_table,
    observed_targets,
)
from fedmlp_tpu_torch.ops import augment as A
from fedmlp_tpu_torch.parallel import step_graph as G
from fedmlp_tpu_torch.parallel.mesh import Place, pad_clients
from fedmlp_tpu_torch.parallel.streaming import TableImages, open_round_images
from fedmlp_tpu_torch.utils import profiling as trace


_BETAS, _ADAM_EPS, _WEIGHT_DECAY = (0.9, 0.999), 1e-8, 5e-4


def torch_adam(params, lr: float) -> torch.optim.Adam:
    """The reference optimizer (utils/local_training.py:636-637), which the
    JAX package's ``torch_adam`` optax chain mirrors: Adam with L2 weight
    decay 5e-4 added to the gradient."""
    return torch.optim.Adam(params, lr=lr, betas=_BETAS, eps=_ADAM_EPS,
                            weight_decay=_WEIGHT_DECAY)


def adam_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr: float) -> None:
    """``torch_adam``'s update of the tensors ``params`` in place, each with
    its own moments and 0-dim step count (so clients that step at different
    times keep their own bias correction): the function that
    ``torch.optim.Adam.step`` calls, with the same choice of foreach
    kernels, so the same gradients give the same bits."""
    with torch.no_grad():
        _adam(params, grads, exp_avgs, exp_avg_sqs, [], steps,
              amsgrad=False, beta1=_BETAS[0], beta2=_BETAS[1], lr=lr,
              weight_decay=_WEIGHT_DECAY, eps=_ADAM_EPS, maximize=False)


def autocast(device: torch.device, compute_dtype: str):
    """bf16 autocast on the card when ``compute_dtype`` is 'bfloat16';
    float32 everywhere else (the CPU always computes in float32)."""
    if compute_dtype == "bfloat16" and device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


# ----------------------------------------------------------------------
# Federated data: device-resident packed arrays + per-client tables
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FederatedData:
    """All static data of a federation, on the device (the images None when
    they stream from disk)."""

    images: torch.Tensor | None  # u8 [N, H, W, 3]
    targets: torch.Tensor      # f32 [N, C] true labels
    obs_targets: torch.Tensor  # f32 [K, M, C] observed (masked) labels
    idx: torch.Tensor          # i64 [K, M] global sample index table
    valid: torch.Tensor        # bool [K, M]
    active: torch.Tensor       # bool [K, C]
    loss_w: torch.Tensor       # f32 [K, C] pos_weight = N_k / class_count
    class_num: torch.Tensor    # f32 [K, C] true per-class counts
    n_local: torch.Tensor      # i32 [K]

    @property
    def n_clients(self) -> int:
        return self.idx.shape[0]

    @property
    def n_classes(self) -> int:
        return self.targets.shape[1]

    @property
    def max_local(self) -> int:
        return self.idx.shape[1]


def build_federated_data(images, targets, dict_users, hidden, active_class_lists,
                         device="cuda", device_images: bool = True) -> FederatedData:
    """Densify the reference's Python-side bookkeeping into tensors
    (reference: DatasetSplit + get_num_of_each_class + loss_w,
    utils/local_training.py:38-43, label masking :1347-1356).
    ``device_images=False`` keeps the images off the device (host
    streaming): ``images`` is None and only the tables go to ``device``."""
    K = len(active_class_lists)
    C = targets.shape[1]
    idx, valid = build_client_index_table(dict_users, K)
    active = build_active_matrix(active_class_lists, C)
    M = idx.shape[1]
    obs = np.zeros((K, M, C), np.float32)
    loss_w = np.zeros((K, C), np.float32)
    class_num = np.zeros((K, C), np.float32)
    n_local = valid.sum(1).astype(np.int32)
    for k in range(K):
        tk = targets[idx[k]]
        obs[k] = observed_targets(tk, hidden[idx[k]], active[k])
        obs[k][~valid[k]] = 0.0
        cn = (tk * valid[k][:, None]).sum(0)
        class_num[k] = cn
        loss_w[k] = n_local[k] / np.maximum(cn, 1e-12)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FederatedData(
        images=dev(images) if device_images else None, targets=dev(targets, torch.float32),
        obs_targets=dev(obs), idx=dev(idx, torch.int64), valid=dev(valid),
        active=dev(active), loss_w=dev(loss_w), class_num=dev(class_num),
        n_local=dev(n_local),
    )


def make_batch_plan(rng: np.random.RandomState, valid: np.ndarray,
                    batch_size: int, local_ep: int):
    """Per-epoch shuffled batch positions for every client → (pos [S, K, B],
    pos_valid [S, K, B], steps_per_epoch), S = local_ep·max_k ⌈n_k/B⌉; the
    same numpy stream as the JAX package, so the plans are identical."""
    valid = np.asarray(valid)
    K, M = valid.shape
    sizes = valid.sum(1)
    steps = int(np.ceil(sizes.max() / batch_size))
    S = local_ep * steps
    pos = np.zeros((S, K, batch_size), np.int32)
    pos_valid = np.zeros((S, K, batch_size), bool)
    for k in range(K):
        mine = np.where(valid[k])[0]
        for e in range(local_ep):
            perm = rng.permutation(mine)
            padded = np.zeros(steps * batch_size, np.int32)
            vmask = np.zeros(steps * batch_size, bool)
            padded[: len(perm)] = perm
            vmask[: len(perm)] = True
            sl = slice(e * steps, (e + 1) * steps)
            pos[sl, k] = padded.reshape(steps, batch_size)
            pos_valid[sl, k] = vmask.reshape(steps, batch_size)
    return pos, pos_valid, steps


def gather_round_images(images: torch.Tensor, idx: torch.Tensor, pos) -> torch.Tensor:
    """(images u8 [N, H, W, 3], idx [K, M], pos [S, K, B]) → the round's
    images u8 [S, K, B, H, W, 3], padding positions included (the JAX
    package's ``gather_round_data``)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=idx.device)
    return TableImages(images, idx, pos).whole()


def pre_augment_views(imgs: torch.Tensor, generator: torch.Generator, *, view_mode: str,
                      augment_backend: str, mean, std, chunk: int = 256,
                      place: Place | None = None) -> dict:
    """Every view of a round, or of a block of it, made before its first
    step: imgs u8 [S, Kr, Br, H, W, 3] → {'x'} (view_mode 'single') or
    {'x1', 'x2'} ('dual': two weak views; 'weak_strong': a weak and a strong
    one), f32 [S, Kr, Br, 3, H, W], for every plan position the images
    hold, padding included.

    The images are the block ``place`` of the round (a mesh rank's clients
    and rows, ``Mesh.place``; by default the whole round, Kr = K and
    Br = B). All N = S·K·B
    images' draws of the WHOLE round come first, the same calls in the same
    order whatever the block (the weak draws of 'x' or 'x1', then those of
    'x2'; every draw is indexed by image on its last axis); then the views
    of the block's positions are made ``chunk`` images at a time from their
    draws. So a block's views are the matching slice of the whole round's,
    and the result does not depend on ``chunk``: the same bits as one call
    over all N, which is what ``make_local_round``'s hoist makes. (The JAX
    package derives the same per-image key tables for every chunk and pads
    the last one to keep one compiled shape; nothing here needs padding.)"""
    if view_mode not in ("single", "dual", "weak_strong"):
        raise ValueError(f"unknown view_mode {view_mode!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    S, Kr, Br, H, W = imgs.shape[:5]
    place = place or Place(Kr, range(Kr), Br, slice(None))
    K, B, clients = place.n_clients, place.batch_size, place.clients
    rows = range(B)[place.rows]
    if (len(clients), len(rows)) != (Kr, Br) or clients.stop > K or rows.stop > B:
        raise ValueError(f"images of {Kr} clients x {Br} rows are not clients "
                         f"{clients} of {K} and rows {rows} of {B}")
    N, Nr = S * K * B, S * Kr * Br
    mine = None  # the block's flat positions in the round, None for all of it
    if Nr != N:
        mine = (torch.arange(S, device=imgs.device)[:, None, None] * (K * B)
                + torch.arange(clients.start, clients.stop, device=imgs.device)[:, None] * B
                + torch.arange(rows.start, rows.stop, device=imgs.device)).reshape(-1)
    flat = imgs.reshape((Nr,) + imgs.shape[3:])
    kinds = {"single": {"x": "weak"}, "dual": {"x1": "weak", "x2": "weak"},
             "weak_strong": {"x1": "weak", "x2": "strong"}}[view_mode]
    backends = {name: A.view_backend(augment_backend, kind) for name, kind in kinds.items()}
    draws = {name: draw(N, H, W, generator, imgs.device)
             for name, (draw, _) in backends.items()}
    views = {}
    for name, (_, apply) in backends.items():
        own = {n: t if mine is None else t[..., mine] for n, t in draws[name].items()}
        parts = [apply(flat[c:c + chunk], {n: t[..., c:c + chunk] for n, t in own.items()},
                       mean, std)
                 for c in range(0, Nr, chunk)]
        if not parts:  # a rank whose block holds no client
            views[name] = torch.empty((S, Kr, Br, 3, H, W), device=imgs.device)
            continue
        v = parts[0] if len(parts) == 1 else torch.cat(parts)
        views[name] = v.reshape((S, Kr, Br) + v.shape[1:])
    return views


# Most view images a round hoists (S·K·B·views): the JAX package's rule
# (fedmlp_tpu/parallel/fl_runtime.py:712-730). Whether a round was hoisted
# decides the order of the generator's draws, so it is part of the knob.
HOIST_MAX_VIEWS = 4096


def _step_setup(data, plan, compute_dtype, needs_global, global_model, global_vars):
    """What every engine's round starts with: (device, the plan's positions
    and valid mask on it, client row indices [K, 1], the autocast context),
    and the frozen global model loaded and in eval mode when needed. The
    device is the tables' (``data['idx']``): the images may stay on disk."""
    device = data["idx"].device
    pos_d = torch.as_tensor(plan["pos"], dtype=torch.int64, device=device)
    if needs_global:
        global_model.load_state_dict(global_vars)
        global_model.eval()
    return (device, pos_d, torch.as_tensor(plan["pos_valid"], device=device),
            torch.arange(pos_d.shape[1], device=device)[:, None],
            autocast(device, compute_dtype))


def _round_views(plan, hoist_augment: bool, n_views: int, src, pos_d, generator,
                 **kw):
    """The views a round brings (``plan['views']``, of the plan's clients
    and rows) or, with ``hoist_augment`` and at most ``HOIST_MAX_VIEWS``
    view images in the WHOLE round (``plan['place']`` under a mesh: JAX
    decides on the global shape), those of the plan's positions made now
    from ``src.whole()`` in one ``pre_augment_views`` call; else None (the
    steps make their own)."""
    made = plan.get("views")
    S, Kr, Br = pos_d.shape
    place = plan.get("place")
    if made is not None and tuple(next(iter(made.values())).shape[:3]) != (S, Kr, Br):
        raise ValueError(f"views made before the round hold positions "
                         f"{tuple(next(iter(made.values())).shape[:3])}, the plan "
                         f"{(S, Kr, Br)}: under a mesh they are the rank's block")
    K, B = (place.n_clients, place.batch_size) if place else (Kr, Br)
    if made is None and hoist_augment and S * K * B * n_views <= HOIST_MAX_VIEWS:
        made = pre_augment_views(src.whole(), generator, chunk=max(S * Kr * Br, 1),
                                 place=place, **kw)
    return made


def _view_maker(view_mode: str, augment_backend: str, mean, std):
    """``augment_views(imgs_u8 [..., H, W, 3], generator)`` → {'x'} or
    {'x1', 'x2'}, f32 [..., 3, H, W]: one call of the backend per view over
    all the images (the first view's draws, then the second's)."""
    if view_mode not in ("single", "dual", "weak_strong"):
        raise ValueError(f"unknown view_mode {view_mode!r}")
    weak = A.pick_weak_backend(augment_backend)
    second = (A.pick_strong_backend(augment_backend) if view_mode == "weak_strong"
              else weak)

    def augment_views(imgs_u8, generator):
        lead = imgs_u8.shape[:-3]
        flat = imgs_u8.reshape((-1,) + imgs_u8.shape[-3:])
        fns = ({"x": weak} if view_mode == "single" else {"x1": weak, "x2": second})
        views = {n: fn(flat, generator, mean, std) for n, fn in fns.items()}
        return {n: v.reshape(lead + v.shape[1:]) for n, v in views.items()}

    return augment_views


def _add_global_logits(global_model, views: dict) -> None:
    """The frozen global model's logits on every view 'x*' of ``views``
    (f32 [..., 3, H, W], one forward over all the leading positions), as
    'g_logits*'."""
    for v in [v for v in views if v.startswith("x")]:
        x = views[v]
        _, g = global_model(x.reshape((-1,) + x.shape[-3:]))
        views["g_logits" + v[1:]] = g.reshape(x.shape[:-3] + g.shape[1:])


# the JAX package's name here for the padded client axis's length
padded_client_count = pad_clients


# a data shard's generator seed: the client's seed plus its data rank times
# this odd constant, modulo 2**64 (JAX folds the data rank into the key)
_DATA_SEED_STRIDE = 0x9E3779B97F4A7C15


def client_generators(generator: torch.Generator, n_clients: int, device,
                      data_rank: int = 0) -> list:
    """A generator of its own for each of ``n_clients`` clients: client k's
    is seeded from the k-th of ``n_clients`` draws of ``generator``, made in
    client order on every rank alike (JAX's ``split(key, K)``), and on data
    shard ``data_rank`` mixed with that rank (JAX's ``fold_in(key,
    axis_index('data'))``)."""
    seeds = torch.randint(0, 2**62, (n_clients,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=device).manual_seed(
        (s + data_rank * _DATA_SEED_STRIDE) % 2**64) for s in seeds]


def _local_part(data: dict, plan: dict, extra_state: dict, place: Place):
    """(data, plan, extra_state) of the block ``place``: its clients and its
    batch rows of every step, client indices counted from the block's
    first. ``plan['live']`` [S, n] keeps whether each step of each client
    is a real one, from its whole batch; ``plan['place']`` is ``place``
    (for ``pre_augment_views``). A ``RoundStream``
    in ``data``, and views made before the round (``plan['views']``), hold
    these clients and rows already (``Trainer.local_pass``)."""
    sl, rows = slice(place.clients.start, place.clients.stop), place.rows
    data = {**data, "idx": data["idx"][sl], "ctx": {n: v[sl] for n, v in data["ctx"].items()}}
    pos_valid = plan["pos_valid"][:, sl]
    plan = {**plan, "pos": plan["pos"][:, sl, rows], "pos_valid": pos_valid[:, :, rows],
            "live": pos_valid.any(2), "sample": {n: t[sl] for n, t in plan["sample"].items()},
            "place": place}
    extra_state = {name: {n: v[sl] for n, v in part.items()}
                   for name, part in extra_state.items()}
    return data, plan, extra_state


def _gathered(mesh, n_clients: int, out: dict, mean_losses, aux: dict):
    """A rank's round outputs of its clients → those of all clients."""
    out = {name: mesh.gather_clients(part, n_clients) for name, part in out.items()}
    losses = mesh.gather_clients({"loss": mean_losses}, n_clients)["loss"]
    return out, losses, mesh.gather_client_dicts(aux, n_clients)


def broadcast_to_clients(variables: dict, n_clients: int) -> dict:
    """Global variables as a client-stacked dict [K, ...] (expanded views,
    no copies): the reference's per-client deepcopy(netglob)."""
    return {n: v[None].expand((n_clients,) + v.shape) for n, v in variables.items()}


def client_vars(stacked: dict, k: int) -> dict:
    return {n: v[k] for n, v in stacked.items()}


class _LossCall(torch.nn.Module):
    """``loss_fn(model, *args)`` as a module, so that
    ``torch.func.functional_call`` runs it on one client's tensors."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args, **kw):
        return self.loss_fn(self.model, *args, **kw)


def streamed_params(model, dtype: torch.dtype) -> dict:
    """{'model.' + name: the float32 parameter rounded to ``dtype`` and
    carried as float32} for ``functional_call`` on a ``_LossCall``: the
    forward reads the rounded values (a convolution under autocast the same
    bits as a ``dtype`` weight; batch norm keeps its float32 arithmetic, as
    flax's with a bfloat16 scale), and the gradient flows back through both
    casts."""
    return {"model." + n: p.to(dtype).to(p.dtype) for n, p in model.named_parameters()
            if p.dtype == torch.float32}


# ----------------------------------------------------------------------
# Local round
# ----------------------------------------------------------------------

def make_local_round(model, loss_fn, *, lr: float, batch_size: int, mean, std,
                     view_mode: str = "single", needs_global: bool = False,
                     teacher_decay: float | None = None,
                     teacher_iter_corrected: bool = False,
                     teacher_scope: str = "all", post_step=None,
                     augment_backend: str = "auto",
                     compute_dtype: str = "float32", global_model=None,
                     teacher_model=None, hoist_augment: bool = False,
                     weight_stream_dtype: torch.dtype | None = None, mesh=None):
    """A function running one local round for every client in turn.

    ``loss_fn(model, views, sample, svalid, ctx, generator, scalars) ->
    loss`` or ``(loss, aux)`` computes ONE client's step loss with ``model``
    in train mode (which updates its batch-norm running statistics). When
    the round carries per-client state it also gets ``cstate=`` (the
    client's state before the step).

    * ``views`` — 'x' (single) or 'x1'/'x2' f32 NCHW views ('dual': two weak
      views; 'weak_strong': a weak and a strong one), plus the frozen global
      model's eval-mode logits 'g_logits' or 'g_logits1'/'g_logits2' when
      ``needs_global``, plus the teacher's eval-mode logits 't_logits'
      (single, on 'x') or 't_logits2' (on 'x2') when a teacher is asked for.
    * ``sample`` — per-sample rows of the plan's [K, M, ...] tables, and
      '_pos' [B], the step's table positions.
    * ``ctx`` — the client's rows of the per-client context.
    * ``aux`` — a dict of per-step tensors (CBAFed's counters), summed over
      the client's steps; a skipped padding step adds nothing.

    A teacher (``teacher_decay`` set; RSCFed, FedIRM) is an EMA of the
    client's model, updated after every real step in float32 with
    α = ``teacher_decay``, or with ``teacher_iter_corrected`` α =
    min(1 − 1/(it + 1), decay), it = ``plan['iter0']`` + the step's index in
    the plan (padding steps count, as the JAX package's scan counter). Scope
    'all' averages every floating entry of the state dict, 'params' the
    parameters only (the teacher's batch-norm statistics stay as they came).
    ``teacher_model`` is the module it runs in, of the model's architecture.

    ``post_step(cstate, aux, sample, svalid, ctx) -> cstate`` (RoFL) runs
    after every real step. The JAX package runs it on padding steps too,
    with zeroed aux, which leaves RoFL's state as it was.

    A round with one generator for all clients (no ``mesh``), no teacher,
    ``post_step``, per-client state or ``weight_stream_dtype``, a
    ``graph_safe`` ``loss_fn``, its images on the device and its views made
    in the step runs its live steps up to the optimizer on a
    ``step_graph.StaticStep``: on a CUDA device, after a few eager steps,
    each a replay of one CUDA graph of the step's gather, forwards and
    backward; elsewhere the same code eagerly. Adam runs eagerly after each
    step, as in every other round.

    Views are made in the step from the step's images, unless the plan
    brings them, or ``hoist_augment`` is set and the round has at most
    ``HOIST_MAX_VIEWS`` view images: then the round first makes all of them
    with ``pre_augment_views`` (one call, its draws before any step's; under
    a mesh the count is the whole round's and the rank makes its block's),
    and step s of client k reads entry [s, k].

    ``round_fn(global_vars, data, plan, scalars, generator, extra_state)``
    takes
      data = {'images' u8 [N,H,W,3], 'idx' [K,M], 'ctx' {name: [K, ...]}}
      plan = {'pos' [S,K,B], 'pos_valid' [S,K,B] (numpy), 'sample'
              {name: [K, M, ...]}, 'iter0' (the lifetime step count),
              optionally 'views' {name: f32 [S,K,B,3,H,W]}, the round's
              views made before it (``pre_augment_views``)}
      extra_state = None or {'teacher': {name: [K, ...]},
                             'cstate': {name: [K, ...]}}
    and returns ({'vars': client-stacked variables, plus 'teacher'/'cstate'
    when they came in}, mean_losses [K], aux sums {name: [K, ...]}). The
    incoming state is only read (it may be ``broadcast_to_clients``'s
    expanded views); what comes out is new memory, one slice a client.
    ``global_model`` is a second module of the same architecture for the
    frozen-global forwards (built when ``needs_global``).

    ``weight_stream_dtype`` (bfloat16; the JAX package's weight streaming):
    each step's loss runs the model on every float32 parameter rounded to
    that type and carried as float32 (``streamed_params``), so the gradient
    reaches the float32 master through the two casts, rounded to the type
    as in JAX; buffers are not cast, and the batch-norm updates land in the
    module's own.

    ``mesh`` (a ``parallel.mesh.Mesh``): the rank runs the clients of its
    block, each on its own generator (``client_generators``), and returns
    every client's outputs, gathered. Over D > 1 data shards each takes its
    B/D rows of every step, with batch-norm statistics over them; the
    gradients are averaged over the data group before Adam, the batch-norm
    statistics and the loss after the step, the aux sums summed, and a step
    is a no-op when its whole batch is padding (JAX's ``pmean``, ``psum``
    and ``pmax(has_any)``); ``post_step`` is refused there, as in JAX.
    Views made before the round come as the rank's block (``Trainer.
    local_pass``); ``hoist_augment`` makes the block's views from the whole
    round's draws, after the K seed draws, and is refused over data shards,
    where JAX drops it.
    """
    if teacher_scope not in ("all", "params"):
        raise ValueError(f"unknown teacher_scope {teacher_scope!r}")
    split_batch = mesh is not None and mesh.data_shards > 1
    if split_batch and post_step is not None:
        raise ValueError("a round over data shards takes no post_step: its per-client "
                         "state would differ between shards")
    if split_batch and hoist_augment:
        raise ValueError("hoist_augment is refused over data shards: the JAX package "
                         "drops it there (fedmlp_tpu/parallel/fl_runtime.py:723)")
    has_teacher = teacher_decay is not None
    augment_views = _view_maker(view_mode, augment_backend, mean, std)
    t_view, t_key = ("x", "t_logits") if view_mode == "single" else ("x2", "t_logits2")
    n_views = 1 if view_mode == "single" else 2
    call = _LossCall(model, loss_fn)
    graphable = (mesh is None and not has_teacher and post_step is None
                 and weight_stream_dtype is None and G.is_graph_safe(loss_fn))
    static = None  # the StaticStep, built at the first round that takes it

    def step_loss(*args, **kw):
        if weight_stream_dtype is None:
            return loss_fn(model, *args, **kw)
        return torch.func.functional_call(
            call, streamed_params(model, weight_stream_dtype), args, kw)

    def ema_pairs():
        """(teacher tensors, model tensors) that the EMA averages."""
        if teacher_scope == "params":
            src = dict(model.named_parameters())
            dst = dict(teacher_model.named_parameters())
        else:
            src, dst = model.state_dict(), teacher_model.state_dict()
        names = [n for n, v in dst.items() if v.is_floating_point()]
        return [dst[n].data for n in names], [src[n].data for n in names]

    def teacher_alpha(it: int) -> tuple[float, float]:
        """(α, 1 − α), each rounded to float32 as the JAX package forms them."""
        one = np.float32(1.0)
        alpha = np.float32(teacher_decay)
        if teacher_iter_corrected:
            alpha = min(one - one / (np.float32(it) + one), alpha)
        return float(alpha), float(one - alpha)

    def static_step(device, data, plan, src, made, pos_d, valid_d, generator, cstate):
        """The round's ``StaticStep``, its tables loaded, or None when the
        round runs the eager loop."""
        nonlocal static
        if not (graphable and cstate is None and made is None
                and isinstance(src, TableImages)):
            return None
        if static is None:
            static = G.StaticStep(list(model.parameters()), augment_views=augment_views,
                                  capture=G.can_capture(device))
        if not static.load_round(images=data["images"], idx=data["idx"], pos=pos_d,
                                 valid=valid_d, sample=plan["sample"], ctx=data["ctx"],
                                 generator=generator):
            return None
        return static

    def run_clients(global_vars, data, plan, scalars, generator, gens, extra_state):
        """The round of the plan's clients in turn; client k draws from
        ``gens[k]``, or all from ``generator`` when ``gens`` is None."""
        pos, pos_valid = plan["pos"], plan["pos_valid"]
        S, K, B = pos.shape
        live = plan.get("live", pos_valid.any(2))
        teacher, cstate = extra_state.get("teacher"), extra_state.get("cstate")
        if has_teacher != (teacher is not None):
            raise ValueError("a round with a teacher needs extra_state['teacher'], "
                             "and one without takes none")
        iter0 = int(plan.get("iter0", 0))
        device, pos_d, valid_d, _, cast = _step_setup(
            data, plan, compute_dtype, needs_global, global_model, global_vars)
        src = open_round_images(data["images"], data["idx"], pos_d, "client")
        made = _round_views(plan, hoist_augment, n_views, src, pos_d, generator,
                            view_mode=view_mode, augment_backend=augment_backend,
                            mean=mean, std=std)
        st = static_step(device, data, plan, src, made, pos_d, valid_d, generator, cstate)

        def forward_backward(views, sample, svalid, ctx, gen, opt, kw):
            """The step on its views up to its optimizer: the frozen-global and
            teacher forwards, the loss and backward → (loss, aux), detached."""
            with cast:
                if needs_global or has_teacher:
                    with trace.span(trace.GLOBAL_FORWARD), torch.no_grad():
                        if needs_global:
                            _add_global_logits(global_model, views)
                        if has_teacher:
                            _, views[t_key] = teacher_model(views[t_view])
                with trace.span(trace.LOSS_FORWARD):
                    res = step_loss(views, sample, svalid, ctx, gen, scalars, **kw)
            with trace.span(trace.BACKWARD):
                loss, aux = res if isinstance(res, tuple) else (res, {})
                opt.zero_grad(set_to_none=True)
                loss.backward()
                return loss.detach().float(), {n: a.detach().float() for n, a in aux.items()}

        stacked = {n: torch.empty((K,) + v.shape, dtype=v.dtype, device=device)
                   for n, v in global_vars.items()}
        out = {"vars": stacked}
        if has_teacher:
            out["teacher"] = {n: torch.empty_like(v, memory_format=torch.contiguous_format)
                              for n, v in teacher.items()}
            teacher_model.eval()
        if cstate is not None:
            out["cstate"] = {n: torch.empty_like(v, memory_format=torch.contiguous_format)
                             for n, v in cstate.items()}
        mean_losses = torch.zeros((K,), dtype=torch.float32, device=device)
        aux_sums = [{} for _ in range(K)]
        for k in range(K):
            gen = generator if gens is None else gens[k]
            with trace.span(trace.CLIENT_SETUP):
                model.load_state_dict(global_vars)
                model.train()
                opt = torch_adam(model.parameters(), lr)
                if has_teacher:
                    teacher_model.load_state_dict(client_vars(teacher, k))
                    t_dst, t_src = ema_pairs()
                kw = {}
                if cstate is not None:
                    kw["cstate"] = {n: v[k].clone() for n, v in cstate.items()}
                ctx = {n: v[k] for n, v in data["ctx"].items()}
                loss_sum = torch.zeros((), dtype=torch.float32, device=device)

            def static_train(views, sample, svalid, ctx):
                return forward_backward(views, sample, svalid, ctx, gen, opt, {})[0]

            cnt = 0
            for s in range(S):
                if not live[s, k]:
                    continue  # padding step: a true no-op
                with trace.span(trace.STEP):
                    if st is not None:
                        loss, aux = st.step(k, s, static_train), {}
                    else:
                        with trace.span(trace.VIEWS):
                            p = pos_d[s, k]
                            sample = {n: t[k, p] for n, t in plan["sample"].items()}
                            sample["_pos"] = p
                            if made is None:
                                views = augment_views(src.client_step(k, s), gen)
                            else:
                                views = {n: v[s, k] for n, v in made.items()}
                        loss, aux = forward_backward(views, sample, valid_d[s, k], ctx, gen,
                                                     opt, kw)
                    with trace.span(trace.OPTIMIZER):
                        if split_batch:
                            # JAX's pmean of the gradients before Adam, of the
                            # batch-norm statistics and the loss after the step;
                            # psum of the aux
                            mesh.data_mean([q.grad for q in model.parameters()
                                            if q.grad is not None])
                        opt.step()
                        if split_batch:
                            mesh.data_mean([b for b in model.buffers() if b.is_floating_point()]
                                           + [loss])
                            mesh.data_sum(list(aux.values()))
                        if has_teacher:
                            with torch.no_grad():
                                alpha, one_minus = teacher_alpha(iter0 + s)
                                torch._foreach_mul_(t_dst, alpha)
                                torch._foreach_add_(t_dst, t_src, alpha=one_minus)
                        if post_step is not None:
                            kw["cstate"] = post_step(kw["cstate"], aux, sample, valid_d[s, k],
                                                     ctx)
                    loss_sum += loss
                    cnt += 1
                    for n, a in aux.items():
                        aux_sums[k][n] = aux_sums[k][n] + a if n in aux_sums[k] else a
            trace.count(trace.STEPS, cnt)
            with trace.span(trace.CLIENT_WRITEBACK):
                mean_losses[k] = loss_sum / max(cnt, 1)
                for n, v in model.state_dict().items():
                    stacked[n][k].copy_(v)
                if has_teacher:
                    for n, v in teacher_model.state_dict().items():
                        out["teacher"][n][k].copy_(v)
                if cstate is not None:
                    for n, v in kw["cstate"].items():
                        out["cstate"][n][k].copy_(v)
        trace.count(trace.CLIENTS, K)
        src.finish()
        return out, mean_losses, _stack_aux(aux_sums)

    def round_fn(global_vars, data, plan, scalars, generator, extra_state=None):
        extra_state = extra_state or {}
        if mesh is None:
            return run_clients(global_vars, data, plan, scalars, generator, None,
                               extra_state)
        _, K, B = plan["pos"].shape
        place = mesh.place(K, B)
        gens = client_generators(generator, K, data["idx"].device, mesh.data_rank)
        parts = _local_part(data, plan, extra_state, place)
        out, losses, aux = run_clients(global_vars, parts[0], parts[1], scalars, generator,
                                       gens[place.clients.start:place.clients.stop],
                                       parts[2])
        return _gathered(mesh, K, out, losses, aux)

    return round_fn


# ----------------------------------------------------------------------
# Lockstep round: steps outside, clients inside (the JAX package's
# ``make_lockstep_local_round``). The training math is the per-client
# loop's; the loop order lets a step's shared work run once for all K
# clients: one view call a view over the K·B step images, one frozen-global
# forward a view at batch K·B.
# ----------------------------------------------------------------------

def _precat(x1, x2):
    """'x12' [K, 2B, ...]: every client's two views [K, B, ...] concatenated
    in one call, each client's slice laid out as ``torch.cat`` lays out the
    concatenation of its own two slices (a view backend may return
    channels-last images), so its forward reads the same tensor."""
    ref = torch.cat([x1[0], x2[0]])
    out = torch.empty_strided((x1.shape[0],) + ref.shape, (ref.numel(),) + ref.stride(),
                              dtype=ref.dtype, device=ref.device)
    return torch.cat([x1, x2], 1, out=out)


def make_lockstep_local_round(model, loss_fn, *, lr: float, batch_size: int, mean, std,
                              view_mode: str = "dual", needs_global: bool = True,
                              augment_backend: str = "auto",
                              compute_dtype: str = "float32", global_model=None,
                              view_precat: bool = False, mesh=None):
    """``make_local_round``'s round for algorithms without a teacher or
    per-client state (FedMLP's two stages, FedNoRo), in the lockstep order:
    each step makes every view once for all K·B images (the first view's
    draws, then the second's), runs the frozen global model once a view at
    batch K·B when ``needs_global``, then computes each client's gradient
    with its own parameters and batch-norm buffers (``torch.func.
    functional_call`` on ``model``; a train-mode batch norm updates the
    client's buffers in place) and applies one Adam update over the clients
    that took a real step (``adam_update``). A client whose step is all
    padding holds its variables, Adam moments and count. ``view_precat``
    concatenates 'x1' and 'x2' once a step into 'x12' [K, 2B, ...], which
    ``fedmlp.loss_fn_viewcat`` reads.

    Same ``round_fn`` signature and outputs as ``make_local_round`` (aux sums
    are empty); views are always made in the step, and ``extra_state`` must
    be None. Against the per-client loop only the generator's order differs
    (all K·B draws of a step at once), and the frozen-global forward's batch.

    ``mesh`` (client shards only, as in JAX): the rank runs its block of
    clients in lockstep on a generator of its own, seeded from the rank's
    draw of C made from ``generator`` (``client_generators``), and returns
    every client's outputs, gathered."""
    if mesh is not None and mesh.data_shards > 1:
        raise ValueError("the lockstep round has no data-parallel path: a mesh of "
                         "client shards only")
    augment_views = _view_maker(view_mode, augment_backend, mean, std)
    call = _LossCall(model, loss_fn)
    pnames = [n for n, _ in model.named_parameters()]

    def round_fn(global_vars, data, plan, scalars, generator, extra_state=None):
        if extra_state or plan.get("views") is not None:
            raise ValueError("the lockstep round makes its views in the step and "
                             "carries no teacher or per-client state")
        if mesh is None:
            return run_lockstep(global_vars, data, plan, scalars, generator)
        _, K, B = plan["pos"].shape
        gen = client_generators(generator, mesh.client_shards,
                                data["idx"].device)[mesh.client_rank]
        data, plan, _ = _local_part(data, plan, {}, mesh.place(K, B))
        return _gathered(mesh, K, *run_lockstep(global_vars, data, plan, scalars, gen))

    def run_lockstep(global_vars, data, plan, scalars, generator):
        pos_valid = plan["pos_valid"]
        S, K, _ = pos_valid.shape
        device, pos_d, valid_d, _, cast = _step_setup(
            data, plan, compute_dtype, needs_global, global_model, global_vars)
        src = open_round_images(data["images"], data["idx"], pos_d, "step")
        with trace.span(trace.CLIENT_SETUP):
            # each client's own tensors, never views of global_vars
            clients = [{"model." + n: v.detach().clone() for n, v in global_vars.items()}
                       for _ in range(K)]
            for c in clients:
                for n in pnames:
                    c["model." + n].requires_grad_(True)
        opt = [{} for _ in range(K)]  # name → (exp_avg, exp_avg_sq, step), as Adam's
        loss_sum = [torch.zeros((), dtype=torch.float32, device=device) for _ in range(K)]
        cnt = [0] * K
        for s in range(S):
            stepping = np.flatnonzero(pos_valid[s].any(1))
            if not len(stepping):
                continue
            trace.count(trace.STEPS, len(stepping))
            with trace.span(trace.STEP):
                with trace.span(trace.VIEWS):
                    p = pos_d[s]
                    views = augment_views(src.step(s), generator)
                if needs_global:
                    with trace.span(trace.GLOBAL_FORWARD), cast, torch.no_grad():
                        _add_global_logits(global_model, views)
                if view_precat and "x1" in views:
                    views["x12"] = _precat(views.pop("x1"), views.pop("x2"))
                update = ([], [], [], [], [])
                for k in stepping:
                    sample = {n: t[k, p[k]] for n, t in plan["sample"].items()}
                    sample["_pos"] = p[k]
                    args = ({n: v[k] for n, v in views.items()}, sample, valid_d[s, k],
                            {n: v[k] for n, v in data["ctx"].items()}, generator, scalars)
                    with trace.span(trace.LOSS_FORWARD), cast:
                        loss = torch.func.functional_call(call, clients[k], args)
                    params = [clients[k]["model." + n] for n in pnames]
                    with trace.span(trace.BACKWARD):
                        grads = torch.autograd.grad(loss, params, allow_unused=True)
                    for n, prm, g in zip(pnames, params, grads):
                        if g is None:  # as Adam skips a parameter without a gradient
                            continue
                        if n not in opt[k]:
                            opt[k][n] = (torch.zeros_like(prm), torch.zeros_like(prm),
                                         torch.tensor(0.0))
                        for lst, t in zip(update, (prm, g) + opt[k][n]):
                            lst.append(t)
                    loss_sum[k] += loss.detach().float()
                    cnt[k] += 1
                with trace.span(trace.OPTIMIZER):
                    adam_update(*update, lr)
        src.finish()
        trace.count(trace.CLIENTS, K)
        with trace.span(trace.CLIENT_WRITEBACK):
            # (a rank of a mesh may hold no client: K = 0)
            out = {n: torch.stack([c["model." + n].detach() for c in clients]) if K
                   else v.new_empty((0,) + v.shape) for n, v in global_vars.items()}
        mean_losses = (torch.stack([ls / max(c, 1) for ls, c in zip(loss_sum, cnt)]) if K
                       else torch.zeros((0,), device=device))
        return {"vars": out}, mean_losses, {}

    return round_fn


# ----------------------------------------------------------------------
# Channel-stacked round: all K clients advance through each step as ONE
# network of K×-wide grouped layers (``models/stacked.py``; the JAX
# package's ``make_stacked_local_round``).
# ----------------------------------------------------------------------

def make_stacked_local_round(model, stacked_loss_fn, *, lr: float, batch_size: int,
                             mean, std, view_mode: str = "single",
                             needs_global: bool = False, augment_backend: str = "auto",
                             compute_dtype: str = "float32", global_model=None,
                             hoist_augment: bool = False):
    """``make_local_round``'s round for algorithms with a
    ``stacked_loss_fn(model, svars, views, sample, svalid, ctx, generator,
    scalars) -> (summed loss, losses [K], new running statistics {name: [K,
    C]})``, where every tensor keeps its [K, ...] client axis and ``svars`` is
    the client-stacked state dict. Each step makes its views with one call a
    view over all K·B images (or reads them from a hoisted round, as
    ``make_local_round`` does), runs the frozen global model, when needed,
    once a view at batch K·B, then one stacked forward and backward for all
    K clients. Adam is ``adam_update`` over one slice of every leaf a client,
    each with its own moments and count, for the clients that took a real
    step; a client whose step is all padding holds its parameters,
    batch-norm statistics, moments and count.

    Same ``round_fn`` signature and outputs as ``make_local_round`` (aux sums
    are empty; ``extra_state`` must be None)."""
    augment_views = _view_maker(view_mode, augment_backend, mean, std)
    n_views = 1 if view_mode == "single" else 2
    pnames = [n for n, _ in model.named_parameters()]

    def round_fn(global_vars, data, plan, scalars, generator, extra_state=None):
        if extra_state:
            raise ValueError("the stacked round carries no teacher or per-client state")
        pos_valid = plan["pos_valid"]
        S, K, _ = pos_valid.shape
        device, pos_d, valid_d, rows, cast = _step_setup(
            data, plan, compute_dtype, needs_global, global_model, global_vars)
        src = open_round_images(data["images"], data["idx"], pos_d, "step")
        made = _round_views(plan, hoist_augment, n_views, src, pos_d, generator,
                            view_mode=view_mode, augment_backend=augment_backend,
                            mean=mean, std=std)
        with trace.span(trace.CLIENT_SETUP):
            svars = {n: v.unsqueeze(0).expand((K,) + v.shape).clone(
                memory_format=torch.contiguous_format) for n, v in global_vars.items()}
            leaves = [svars[n].requires_grad_() for n in pnames]
            exp_avgs = [torch.zeros_like(t) for t in leaves]
            exp_avg_sqs = [torch.zeros_like(t) for t in leaves]

            def slices(ts, k):
                return [t.detach()[k] for t in ts]

            # client k's Adam works on the k-th slices, with counts of its own
            per_client = [(slices(leaves, k), slices(exp_avgs, k), slices(exp_avg_sqs, k),
                           [torch.tensor(0.0) for _ in leaves]) for k in range(K)]
        loss_sum = torch.zeros((K,), dtype=torch.float32, device=device)
        cnt = torch.zeros((K,), dtype=torch.float32, device=device)
        for s in range(S):
            stepping = np.flatnonzero(pos_valid[s].any(1))
            if not len(stepping):
                continue
            trace.count(trace.STEPS, len(stepping))
            with trace.span(trace.STEP):
                with trace.span(trace.VIEWS):
                    p = pos_d[s]
                    if made is None:
                        views = augment_views(src.step(s), generator)
                    else:
                        views = {n: v[s] for n, v in made.items()}
                    sample = {n: t[rows, p] for n, t in plan["sample"].items()}
                    sample["_pos"] = p
                with cast:
                    if needs_global:
                        with trace.span(trace.GLOBAL_FORWARD), torch.no_grad():
                            _add_global_logits(global_model, views)
                    with trace.span(trace.LOSS_FORWARD):
                        loss, loss_k, new_stats = stacked_loss_fn(
                            model, svars, views, sample, valid_d[s], data["ctx"], generator,
                            scalars)
                with trace.span(trace.BACKWARD):
                    grads = torch.autograd.grad(loss, leaves)
                with trace.span(trace.OPTIMIZER):
                    update = ([], [], [], [], [])
                    for k in stepping:
                        prm, m, v, st = per_client[k]
                        for lst, ts in zip(update, (prm, [g[k] for g in grads], m, v, st)):
                            lst.extend(ts)
                    adam_update(*update, lr)
                    keep = torch.as_tensor(pos_valid[s].any(1), device=device)
                    with torch.no_grad():
                        for n, new in new_stats.items():
                            held = keep.view((K,) + (1,) * (new.dim() - 1))
                            svars[n].copy_(torch.where(held, new, svars[n]))
                        loss_sum += torch.where(keep, loss_k.detach().float(), 0.0)
                        cnt += keep
        src.finish()
        trace.count(trace.CLIENTS, K)
        mean_losses = loss_sum / torch.clamp(cnt, min=1.0)
        return {"vars": {n: svars[n].detach() for n in global_vars}}, mean_losses, {}

    return round_fn


def _stack_aux(aux_sums: list) -> dict:
    """Per-client aux sums → {name: [K, ...]}; a client that ran no step
    contributes zeros."""
    template = next((a for a in aux_sums if a), {})
    return {n: torch.stack([a.get(n, torch.zeros_like(t)) for a in aux_sums])
            for n, t in template.items()}


# ----------------------------------------------------------------------
# Feature harvest: per-client features + probs over the padded table
# (FedMLP prototype/τ extraction, reference utils/local_training.py:
#  971-1002, 1023-1049, 1208-1250)
# ----------------------------------------------------------------------

def make_harvest_fn(model, mean, std, batch_size: int, augment_backend: str = "auto",
                    compute_dtype: str = "float32", mesh=None):
    """``harvest(stacked_vars, images, idx [K, M], generator, loader=None)``
    → (features [K, M, D], probs [K, M, C]): each client's own weights, in
    eval mode, over its table in chunks of ``batch_size`` (the last chunk
    edge-padded), on the weak view as the reference's image_aug_1
    (utils/local_training.py:982). With ``images`` None the chunks stream
    from ``loader`` (a ``PackLoader`` over the packed shard), chunk j+1
    gathered on the loader's thread while chunk j runs, as the JAX
    package's harvest (``fl_runtime.py:1501-1546``; its chunk is all K
    clients' j-th, here one client's, in the order they run).

    ``mesh``: the rank harvests the clients of its block, client k on its
    own generator (``client_generators``, every data shard alike), and
    returns every client's features and probabilities, gathered."""
    weak = A.pick_weak_backend(augment_backend)

    @torch.no_grad()
    def harvest(stacked_vars, images, idx, generator, loader=None):
        with trace.span(trace.HARVEST, idx.device):
            K, M = idx.shape
            clients, gens = range(K), None
            if mesh is not None:
                clients = mesh.client_block(K)
                gens = client_generators(generator, K, idx.device)
            nb = math.ceil(M / batch_size)
            pad = nb * batch_size - M
            idx_p = torch.cat([idx, idx[:, -1:].expand(K, pad)], 1) if pad else idx
            cast = autocast(idx.device, compute_dtype)
            if images is None:
                if loader is None:
                    raise ValueError("a harvest of streamed images needs the loader")
                chunks = idx_p[clients.start:clients.stop].cpu().numpy().reshape(-1, batch_size)
                if len(chunks):
                    loader.submit(chunks[0])
            feats, probs = [], []
            for i, k in enumerate(clients):
                gen = generator if gens is None else gens[k]
                model.load_state_dict(client_vars(stacked_vars, k))
                model.eval()
                fk, pk = [], []
                for j in range(nb):
                    if images is None:
                        with trace.span(trace.LOADER_WAIT):
                            host = loader.wait()
                        if i * nb + j + 1 < len(chunks):
                            loader.submit(chunks[i * nb + j + 1])
                        imgs = loader.to_device(host, idx.device)
                    else:
                        imgs = images[idx_p[k, j * batch_size:(j + 1) * batch_size]]
                    x = weak(imgs, gen, mean, std)
                    with cast:
                        f, logits = model(x)
                    fk.append(f.float())
                    pk.append(torch.sigmoid(logits.float()))
                feats.append(torch.cat(fk)[:M])
                probs.append(torch.cat(pk)[:M])
            if mesh is None:
                return torch.stack(feats), torch.stack(probs)
            # a rank past the last client holds none: the widths from the head
            f = torch.stack(feats) if feats else idx.new_zeros(
                (0, M, model.head.in_features), dtype=torch.float32)
            p = torch.stack(probs) if probs else idx.new_zeros(
                (0, M, model.head.num_classes), dtype=torch.float32)
            out = mesh.gather_clients({"f": f, "p": p}, K)
            return out["f"], out["p"]

    return harvest


# ----------------------------------------------------------------------
# Evaluation forward
# ----------------------------------------------------------------------

def make_eval_fn(model, mean, std, batch_size: int = 128,
                 compute_dtype: str = "float32"):
    @torch.no_grad()
    def evaluate_probs(global_vars, images_u8) -> np.ndarray:
        """Probabilities [N, C] of the global model on host u8 NHWC images,
        sent to the device one chunk at a time."""
        device = next(model.parameters()).device
        model.load_state_dict(global_vars)
        model.eval()
        cast = autocast(device, compute_dtype)
        out = []
        for s in range(0, images_u8.shape[0], batch_size):
            chunk = torch.as_tensor(np.asarray(images_u8[s:s + batch_size]),
                                    device=device)
            with cast:
                _, logits = model(A.eval_batch(chunk, mean, std))
            out.append(torch.sigmoid(logits.float()).cpu().numpy())
        return np.concatenate(out, axis=0)

    return evaluate_probs
