"""The per-client loop's live step on buffers that keep their addresses,
captured once in a CUDA graph and replayed for every later step
(``fl_runtime.make_local_round``).

Eager, a step of the per-client loop launches its kernels one by one from
Python (about 1,900 a ResNet-18 step and 4,400 an EfficientNet-B0 step of
FedMLP stage 1), and the host takes longer to launch them than the card takes
to run them. ``StaticStep`` gathers a step's inputs from tensors at fixed
addresses alone and then runs the loop's own step on them, so one capture of
the two replays for every step of every client and round:

* the round's tables, copied in once a round (``load_round``): the plan's
  positions and valid mask [S, K, B], the client index table [K, M], the
  sample arrays [K, M, ...] and the clients' context rows [K, ...]; the
  images table itself is held, and a round with another one runs eagerly;
* ``sel``, the device pair (k, s·K + k) that picks the step: client k's rows
  of the index, sample and context tables, and step s's row of the position
  and valid tables. Each step writes it by one device-to-device copy from
  ``pairs`` [S, K, 2], which holds every step's pair;
* the model's and the frozen global model's parameters and buffers
  (``load_state_dict`` copies in place), and the gradients, which the
  capture allocates and each replay writes.

The optimizer stays out of the graph: after each step, replayed or not, the
loop runs its own Adam eagerly (created afresh for each client, as always),
a few foreach launches that read the gradients where the replay wrote them.
So a graphed round is the eager loop's bit for bit, and the optimizer's
hooks fire on every step.

A step's random draws (the views, dropout, stochastic depth) come from the
round's generator, registered with the graph: a replay takes the draws the
eager step would take at that point of the generator's stream, and advances
it as far.

The step after the gather is the per-client loop's forward and backward
(``train``, given to ``step``; the eager loop calls the same function after
its own gather). The first ``WARMUP_STEPS`` live steps run eagerly, so that
cuDNN and the lazy state meet their first calls outside a capture. The next
live step is captured, then replayed, and every later step replays. The
capture records the step's kernel-wrapper launches (``LAUNCH_COUNTS`` of the
ops modules) and every program counter that the captured body counted (the
attention's of ``models/swin.py``; ``fedmlp.graph_*`` aside), undoes what the
capture counted, and each replay adds them again, so a graphed round counts
what an eager round counts.

Where nothing can be captured (the CPU, or a torch whose graphs take no
generator of their own) the static step runs eagerly every time, the same
arithmetic as the loop's own gather: the CPU tests run it so.
"""

from __future__ import annotations

import torch

from fedmlp_tpu_torch.ops import dw_pallas, fused_conv_bn, pallas_ops, warp
from fedmlp_tpu_torch.utils import profiling as trace

# eager live steps before the capture
WARMUP_STEPS = 3
_LAUNCH_COUNTS = (warp.LAUNCH_COUNTS, dw_pallas.LAUNCH_COUNTS, fused_conv_bn.LAUNCH_COUNTS,
                  pallas_ops.LAUNCH_COUNTS)


def graph_safe(loss_fn):
    """Mark ``loss_fn`` as one whose step may be captured in a CUDA graph:
    it synchronizes nothing with the host, its shapes do not depend on the
    data, it returns the loss alone (no aux), and it reads nothing of
    ``scalars`` (a replay repeats the values the capture saw)."""
    loss_fn.graph_safe = True
    return loss_fn


def is_graph_safe(loss_fn) -> bool:
    return getattr(loss_fn, "graph_safe", False)


def can_capture(device: torch.device) -> bool:
    """Whether a step on ``device`` is captured: a CUDA device, and a torch
    whose graphs take a generator of their own."""
    return device.type == "cuda" and hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def _shapes(tables: dict) -> tuple:
    return tuple((n, tuple(t.shape), t.dtype) for n, t in sorted(tables.items()))


class StaticStep:
    """The per-client loop's live step up to its optimizer, on fixed
    buffers, eager or replayed from its graph. ``params`` are the model's
    parameters, whose gradients the step writes; ``augment_views`` is the
    loop's view maker."""

    def __init__(self, params, *, augment_views, capture: bool):
        self.params, self.augment_views, self.capture = params, augment_views, capture
        self.key = None  # what the buffers were made for
        self.graph = None
        self.eager_steps = 0
        self.launches = []  # (counter dict, name, launches a replay makes)
        self.counts = []  # (program counter, what a replay adds)

    def load_round(self, *, images, idx, pos, valid, sample, ctx, generator) -> bool:
        """Copy a round's tables in (device tensors: ``pos`` int64 and
        ``valid`` bool [S, K, B]); False, and nothing copied, when they do
        not fit the captured graph's buffers, and the round runs eagerly."""
        key = (images.data_ptr(), tuple(images.shape), images.dtype, tuple(idx.shape),
               tuple(pos.shape), _shapes(sample), _shapes(ctx), id(generator))
        if key != self.key:
            if self.graph is not None:
                return False
            self._make_buffers(images, idx, pos, sample, ctx, generator)
            self.key = key
        if self.graph is not None:
            # the gradients a replay writes: an eager step since may have
            # set others in their place
            for q, g in zip(self.params, self.grads):
                q.grad = g
        self.idx.copy_(idx)
        self.pos.copy_(pos.reshape(self.pos.shape))
        self.valid.copy_(valid.reshape(self.valid.shape))
        for n, t in sample.items():
            self.sample[n].copy_(t)
        for n, t in ctx.items():
            self.ctx[n].copy_(t)
        return True

    def _make_buffers(self, images, idx, pos, sample, ctx, generator) -> None:
        device = idx.device
        S, K, B = pos.shape
        # held, so that the key's address stays this table's
        self.images, self.generator = images, generator
        self.idx = torch.empty_like(idx, memory_format=torch.contiguous_format)
        self.pos = torch.empty((S * K, B), dtype=torch.int64, device=device)
        self.valid = torch.empty((S * K, B), dtype=torch.bool, device=device)
        self.sample = {n: torch.empty_like(t, memory_format=torch.contiguous_format)
                       for n, t in sample.items()}
        self.ctx = {n: torch.empty_like(t, memory_format=torch.contiguous_format)
                    for n, t in ctx.items()}
        flat = torch.arange(S * K, device=device).view(S, K)
        self.pairs = torch.stack([flat % K, flat], -1)
        self.sel = torch.zeros((2,), dtype=torch.int64, device=device)

    def step(self, k: int, s: int, train) -> torch.Tensor:
        """Step s of client k up to its optimizer: a replay, or the gather
        and then ``train(views, sample, svalid, ctx)`` eagerly (the capture
        first, once the warm-up is done) → the step's loss, which a replay
        writes in place."""
        self.sel.copy_(self.pairs[s, k])
        if self.graph is None:
            if self.eager_steps < WARMUP_STEPS or not self.capture:
                self.eager_steps += 1
                return self._body(train)
            self._capture(train)
        self.graph.replay()
        for counts, name, n in self.launches:
            counts[name] += n
        for name, n in self.counts:
            trace.count(name, n)
        trace.count(trace.GRAPH_STEPS)
        return self.loss

    def _capture(self, train) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = [dict(c) for c in _LAUNCH_COUNTS]
        counted = dict(trace.counters())
        with torch.cuda.graph(graph):
            self.loss = self._body(train)
        for counts, was in zip(_LAUNCH_COUNTS, before):
            for name, n in counts.items():
                if n != was[name]:  # the capture counted launches that did not run
                    self.launches.append((counts, name, n - was[name]))
                    counts[name] = was[name]
        for name, n in list(trace.counters().items()):
            n -= counted.get(name, 0)
            if n and not name.startswith("fedmlp.graph_"):  # nor did the counted work
                self.counts.append((name, n))
                trace.count(name, -n)
        self.grads = [q.grad for q in self.params]
        self.graph = graph
        trace.count(trace.GRAPH_CAPTURES)

    def _body(self, train) -> torch.Tensor:
        """The step's rows gathered by ``sel``, then ``train``. Under a
        capture the spans time the capture."""
        k, flat = self.sel[:1], self.sel[1:]
        with trace.span(trace.VIEWS):
            p = self.pos.index_select(0, flat)[0]
            svalid = self.valid.index_select(0, flat)[0]
            rows = self.idx.index_select(0, k)[0].index_select(0, p)
            sample = {n: t.index_select(0, k)[0].index_select(0, p)
                      for n, t in self.sample.items()}
            sample["_pos"] = p
            ctx = {n: t.index_select(0, k)[0] for n, t in self.ctx.items()}
            views = self.augment_views(self.images.index_select(0, rows), self.generator)
        return train(views, sample, svalid, ctx)
