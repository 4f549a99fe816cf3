"""The ResNets' channels-last activations (``models/resnet.py``), on the CPU.

* A forward hook on the stem, every block and every batch norm of ResNet-18
  and of SE-ResNet-50 at 64 px sees channels-last activations, in train and
  eval mode, in float32 and under bf16 autocast, and under ``remat`` (the
  recompute too); the feature the head takes is a plain ``[B, C]``.
* Parameters, gradients and ``state_dict`` keep PyTorch's default layout
  after a trained step, so the aggregation and ``weights.py`` see what they
  always saw.
* A per-client-loop round on ResNet-18 counts ``fedmlp.nhwc_forwards`` once
  for every ResNet forward it runs, also when its steps are replays (a CUDA
  graph faked on the CPU: the capture's count undone, each replay's added);
  an EfficientNet-B0 round counts none.

The ResNets' parity with the JAX package is held by
``tests/test_torch_backbones.py`` and the round tests, unchanged.
"""

import contextlib

import numpy as np
import pytest
import torch

from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.models.layers import BatchNorm
from fedmlp_tpu_torch.models.resnet import ResNet
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.parallel import step_graph as G
from fedmlp_tpu_torch.utils import profiling as P
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

IMG, C = 64, 4
CL = torch.channels_last


def _model(name, **kw):
    return init_model(build_model(name, C, image_size=IMG, **kw), 3)


def _hooked(model):
    """Forward hooks on the stem's batch norm, every block and every batch
    norm → the list they fill with (module name, shape, channels-last)."""
    seen = []
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm) or name in model.block_names:
            mod.register_forward_hook(lambda m, i, o, name=name: seen.append(
                (name, tuple(o.shape), o.is_contiguous(memory_format=CL))))
    return seen


@pytest.mark.parametrize("name", ["resnet18", "senet50"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_activation_is_channels_last(name, train, dtype):
    model = _model(name).train(train)
    seen = _hooked(model)
    x = torch.randn(2, 3, IMG, IMG)
    assert x.is_contiguous() and not x.is_contiguous(memory_format=CL)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
        feature, logits = model(x)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert len(seen) == n_bn + len(model.block_names)
    # no map here is 1×1, where the two layouts are one: the check has teeth
    assert min(h * w for _, (_, _, h, w), _ in seen) > 1
    assert [s for s in seen if not s[2]] == []
    assert feature.shape == (2, model.feature_dim) and feature.is_contiguous()
    assert feature.dtype == torch.float32 and logits.shape == (2, C)


def test_the_recompute_of_remat_runs_channels_last():
    model = _model("resnet18", remat=True).train()
    seen = _hooked(model)
    feature, logits = model(torch.randn(2, 3, IMG, IMG))
    forward = len(seen)
    logits.sum().backward()
    assert len(seen) > forward  # the blocks ran again in the backward
    assert [s for s in seen if not s[2]] == []


@pytest.mark.parametrize("name", ["resnet18", "senet50"])
def test_parameters_gradients_and_state_dict_keep_their_layout(name):
    model = _model(name).train()
    opt = rt.torch_adam(model.parameters(), 1e-3)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        _, logits = model(torch.randn(2, 3, IMG, IMG))
    logits.float().sum().backward()
    opt.step()
    for n, q in model.named_parameters():
        assert q.is_contiguous() and q.grad.is_contiguous(), n
    convs = [n for n, t in model.state_dict().items() if t.dim() == 4]
    assert convs  # the 4-d weights, where the layouts could differ
    for n, t in model.state_dict().items():
        assert t.is_contiguous(), n


def _federation():
    rng = np.random.RandomState(0)
    sizes = (6, 4)
    n = sum(sizes)
    images = rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    users = {0: list(range(6)), 1: list(range(6, n))}
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    fd = rt.build_federated_data(images, targets, users, np.zeros_like(targets, bool),
                                 [[0], [1]], device="cpu")
    pos, pos_valid, _ = rt.make_batch_plan(np.random.RandomState(0), fd.valid.numpy(), 2, 1)
    active = fd.active.float()
    data = {"images": fd.images, "idx": fd.idx,
            "ctx": {"active": active, "negative": 1.0 - active, "loss_w": fd.loss_w}}
    return data, {"pos": pos, "pos_valid": pos_valid, "sample": {"labels": fd.obs_targets}}


class _FakeGraph:
    """A CUDA graph on the CPU: the capture runs the body eagerly (and
    counts), a replay runs nothing."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def _unmarked(loss_fn):
    def loss(*a, **kw):
        return loss_fn(*a, **kw)
    return loss


def _round(name, loss_fn):
    """One FedMLP stage-1 round of the per-client loop on ``name`` at 32 px →
    (the round's counters, the ResNet forwards its models ran)."""
    data, plan = _federation()
    model, glob = build_model(name, C, image_size=32), build_model(name, C, image_size=32)
    forwards = []
    for m in (model, glob):
        if isinstance(m, ResNet):
            m.register_forward_pre_hook(lambda mod, args: forwards.append(mod))
    gv = {n: v.clone() for n, v in init_model(build_model(name, C, image_size=32), 3)
          .state_dict().items()}
    fn = rt.make_local_round(model, loss_fn, lr=1e-3, batch_size=2, mean=(0.5,) * 3,
                             std=(0.25,) * 3, view_mode="dual", needs_global=True,
                             augment_backend="normonly", global_model=glob)
    P.reset()
    with P.round_record(0):
        fn(gv, data, plan, {}, torch.Generator().manual_seed(1))
    return P.HISTORY[-1]["counters"], len(forwards), int(plan["pos_valid"].any(2).sum())


def test_a_resnet18_round_counts_its_forwards(monkeypatch):
    counters, forwards, live = _round("resnet18", _unmarked(tfedmlp.loss_fn))
    assert forwards >= 2 * live  # a trained and a frozen-global forward a step at least
    assert counters[P.NHWC_FORWARDS] == forwards
    # the static step, its steps after the warm-up replays of a faked graph:
    # the capture's count undone, each replay's added
    monkeypatch.setattr(G, "can_capture", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    graphed, graphed_forwards, _ = _round("resnet18", tfedmlp.loss_fn)
    assert graphed[P.GRAPH_STEPS] == live - G.WARMUP_STEPS
    assert graphed_forwards < forwards  # the replays ran nothing
    assert graphed[P.NHWC_FORWARDS] == forwards


def test_an_efficientnet_round_counts_none():
    counters, forwards, live = _round("efficient_b0", tfedmlp.loss_fn)
    assert live > 0 and forwards == 0
    assert P.NHWC_FORWARDS not in counters
