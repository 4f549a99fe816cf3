"""Block rematerialization (``remat``, ``remat_stages``) and weight streaming
(``weight_stream``) in the port (fedmlp_tpu_torch/models/layers.py::remat,
models/{efficientnet,resnet,factory}.py, parallel/fl_runtime.py::
make_local_round, train.py) on the CPU.

Rematerialization changes what the backward keeps, never what it computes,
so the tests hold it to no remat bit for bit: the loss, every gradient, the
running statistics after an Adam step (a second update in the recompute
would move them) and the generator's state (a second drop-connect draw
would move it); and to the JAX package's ``nn.remat`` B0 in float64.
Weight streaming runs the step on the parameters rounded to bfloat16, so
the tests hold it to the same step on parameters rounded first, as JAX's
cast gives it, and a round of it to the JAX package's round.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.config import Config as JConfig, DataConfig as JData
from fedmlp_tpu.models import build_model as j_build_model
from fedmlp_tpu.models.factory import init_model as j_init_model
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu.train import Trainer as JTrainer

from fedmlp_tpu_torch.algos import cbafed, fedirm, fedmlp, rofl, rscfed
from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig
from fedmlp_tpu_torch.models import build_model, init_model, layers
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.train import Trainer
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_variables import flax_shapes, numpy_variables


def _step(model, x, generator=None):
    """One train-mode step (loss Σ logits², ``torch_adam``): the loss, the
    gradients, then the state dict after the update."""
    model.train()
    opt = rt.torch_adam(model.parameters(), 1e-3)
    _, logits = model(x, generator)
    loss = (logits ** 2).sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    return loss.detach(), grads, {n: v.clone() for n, v in model.state_dict().items()}


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for i in (1, 2):
        assert a[i].keys() == b[i].keys()
        for n in a[i]:
            assert torch.equal(a[i][n], b[i][n]), n


@pytest.mark.parametrize("kw,names", [
    (dict(remat=True), None),
    (dict(remat_stages=(0, 1)), {"block0_0", "block1_0", "block1_1"}),
])
def test_remat_is_bit_for_bit_on_b0_with_drop_connect(kw, names):
    """B0 at 32 px, batch 4, dropout and drop-connect drawn from a
    generator: remat of every block and of stages 0 and 1 against no
    remat."""
    sd = init_model(build_model("efficient_b0", 3), 0).state_dict()
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32))
    out, states = [], []
    for build in ({}, kw):
        m = build_model("efficient_b0", 3, **build)
        m.load_state_dict(sd)
        g = torch.Generator()
        g.manual_seed(7)
        out.append(_step(m, x, g))
        states.append(g.get_state())
    assert m.remat_names == (names or set(m.block_names))
    assert any(getattr(m, n).drops for n in m.remat_names)
    _assert_same(out[0], out[1])
    assert torch.equal(states[0], states[1])
    # the running statistics moved once, not twice
    assert not torch.equal(out[1][2]["block1_1.dw_bn.running_mean"],
                           sd["block1_1.dw_bn.running_mean"])


@pytest.fixture(scope="module")
def jax_remat_b0():
    """A train step of the JAX package's rematerialized B0 (``remat=True``:
    ``nn.remat(MBConv)`` on every block), float64 but for the float32 head,
    batch 4 at 32 px, loss Σ logits², from weights drawn with numpy in
    flax's shapes (batch-norm scales, biases and running statistics drawn
    away from their init; tests/torch_variables.py): the weights, the
    input, the logits, and every parameter gradient and running statistic
    after the step, computed once a module for both cases below."""
    x = np.random.RandomState(6).randn(4, 32, 32, 3)
    with jax.enable_x64():
        jm = j_build_model("efficient_b0", 3, compute_dtype=jnp.float64, remat=True)
        v = numpy_variables(flax_shapes(jm, 32, train=False), 2, perturb=True)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def jloss(params):
            (_, logits), mut = jm.apply({"params": params,
                                         "batch_stats": v64["batch_stats"]}, x,
                                        train=True, mutable=["batch_stats"])
            return jnp.sum(logits.astype(jnp.float64) ** 2), (logits, mut)

        (_, (jlogits, mut)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            v64["params"])
        want = from_jax_variables(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            {"params": jgrads, "batch_stats": mut["batch_stats"]}))
        jl = np.asarray(jlogits, np.float64)
    return v, x, jl, want


@pytest.mark.parametrize("kw", [dict(remat=True), dict(remat_stages=(0, 1))])
def test_remat_b0_matches_jax_in_float64(jax_remat_b0, kw):
    """A train step of the port's rematerialized B0 (every block, and
    stages 0 and 1) against the JAX package's ``nn.remat`` B0 with the same
    weights (``jax_remat_b0``; remat changes what the backward keeps, never
    what it computes, and the JAX package's tests/test_models.py holds its
    ``remat_stages`` model to its model without remat): the logits, every
    parameter gradient and the running statistics after the step (flax
    keeps the forward's update and drops the recompute's) within 1e-6 of
    the largest magnitude of each. No dropout generator on either side
    (JAX's draws are not the port's); the port's own bit-for-bit test above
    covers drop-connect."""
    v, x, jl, want = jax_remat_b0
    tm = build_model("efficient_b0", 3, **kw)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tm.double().head.float()
    tm.train()
    _, logits = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    (logits.double() ** 2).sum().backward()
    np.testing.assert_allclose(logits.detach().double().numpy(), jl, rtol=0,
                               atol=1e-6 * np.abs(jl).max())
    got = {n: p.grad for n, p in tm.named_parameters()}
    got.update((n, b) for n, b in tm.named_buffers())
    assert set(got) == set(want)
    grads = [n for n, _ in tm.named_parameters()]
    for names in (grads, [n for n in want if n not in grads]):
        scale = max(float(want[n].abs().max()) for n in names)
        for n in names:
            np.testing.assert_allclose(got[n].double().numpy(), want[n].double().numpy(),
                                       rtol=0, atol=1e-6 * scale, err_msg=n)


def test_remat_is_bit_for_bit_on_resnet18():
    sd = init_model(build_model("resnet18", 3), 0).state_dict()
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 32, 32).astype(np.float32))
    out = []
    for remat in (False, True):
        m = build_model("resnet18", 3, remat=remat)
        m.load_state_dict(sd)
        out.append(_step(m, x))
    _assert_same(out[0], out[1])


def test_remat_reaches_only_jax_families():
    """``build_model``'s rule: ``remat`` for EfficientNet, ResNet and the
    SE-ResNets, ``remat_stages`` for EfficientNet; dropped elsewhere
    (modules built on the meta device: only their structure is read)."""
    with torch.device("meta"):
        assert build_model("Resnet18", 3, remat=True).remat
        assert build_model("senet50", 3, remat=True).remat
        assert not build_model("resnet18", 3, remat_stages=(0,)).remat
        for name in ("vgg11", "dense121", "senet154", "smallcnn"):
            build_model(name, 3, remat=True, remat_stages=(0, 1))  # accepted, dropped
        assert build_model("efficient_b0", 3, remat_stages=(6,)).remat_names == {"block6_0"}


def test_remat_checkpoints_only_training_with_gradients(monkeypatch):
    """The frozen-global and teacher twins (eval mode), the harvest and the
    evaluation (no gradients) run plain forwards."""
    calls = []
    real = layers.checkpoint
    monkeypatch.setattr(layers, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    m = init_model(build_model("efficient_b0", 3, remat=True), 0)
    x = torch.randn(2, 3, 32, 32)
    m.eval()
    m(x)
    m.train()
    with torch.no_grad():
        m(x)
    assert not calls
    m(x)
    assert len(calls) == 16


def _cfg(**kw):
    base = dict(
        algorithm="fedavg", model="smallcnn", batch_size=16, base_lr=1e-3,
        n_clients=2, local_ep=1, rounds_warmup=4, eval_every=100, seed=5,
        data=DataConfig(name="synthetic", n_classes=3, image_size=32,
                        synthetic_train_size=32, synthetic_test_size=8),
        compute_dtype="float32", output_dir="",
    )
    base.update(kw)
    return Config(**base)


def _round(t):
    state, losses, _ = t.local_pass(t.round_fn, {"labels": t.fd.obs_targets},
                                    t.round_scalars(0))
    return losses, state["vars"]


def test_remat_on_the_lockstep_engine_is_bit_for_bit():
    """The lockstep engine runs each client's forward through
    ``functional_call`` on the client's own tensors; the recompute must read
    those, not the module's. FedMLP stage 1 on B0 (drop-connect on), 2
    clients, with and without remat."""
    out = []
    for remat in (0, 1):
        t = Trainer(_cfg(algorithm="fedmlp", model="efficient_b0", batch_size=8,
                         batched_global="on", remat=remat,
                         fedmlp=FedMLPConfig(rounds_stage1=2)), device="cpu")
        out.append(_round(t))
    assert torch.equal(out[0][0], out[1][0])
    for n, v in out[0][1].items():
        assert torch.equal(v, out[1][1][n]), n


def test_weight_stream_gradient_is_the_rounded_gradient():
    """One step through ``streamed_params``: the same loss bits as the step
    on parameters rounded to bfloat16 first, the float32 master's gradient
    the bfloat16 rounding of that step's gradient (the cotangent of JAX's
    ``astype``), buffers neither cast nor updated differently."""
    torch.manual_seed(0)
    model = init_model(build_model("smallcnn", 3), 0).train()
    ref = init_model(build_model("smallcnn", 3), 0).train()
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.to(torch.bfloat16))
    x = torch.randn(8, 3, 32, 32)
    call = rt._LossCall(model, lambda m, x: (m(x)[1] ** 2).sum())
    loss = torch.func.functional_call(call, rt.streamed_params(model, torch.bfloat16), (x,))
    loss.backward()
    want = (ref(x)[1] ** 2).sum()
    want.backward()
    assert torch.equal(loss, want)
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        assert p.dtype == torch.float32
        assert torch.equal(p.grad, q.grad.to(torch.bfloat16).float()), n
    for (n, b), c in zip(model.named_buffers(), ref.buffers()):
        assert b.dtype == torch.float32 and torch.equal(b, c), n
    assert not any("running" in n for n in rt.streamed_params(model, torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_streamed_gradient_is_the_rounded_gradient(dtype):
    """The identity that the test above holds the port to, in the JAX
    package: its step's cast (``fl_runtime.make_local_round``'s ``lf``: each
    float32 parameter ``astype(bfloat16)``) under ``jax.value_and_grad``, on
    the smallcnn in train mode, gives the same loss bits as the step on
    parameters rounded to bfloat16 first, and as gradient that step's
    gradient rounded to bfloat16. With the float32 model (float32
    arithmetic on the rounded values, the port's on the CPU) that holds
    for every leaf. With the bfloat16 model the convolution kernels'
    gradient is the unrounded one on both sides: XLA on the CPU computes a
    bfloat16 convolution in float32 and, allowed excess precision (its
    default), drops the float32→bfloat16→float32 pair of the cast and its
    cotangent; every other leaf is rounded."""
    jm = j_build_model("smallcnn", 3, compute_dtype=jnp.dtype(dtype))
    v = j_init_model(jm, jax.random.PRNGKey(0), 32)
    x = jnp.asarray(np.random.RandomState(4).randn(8, 32, 32, 3), jnp.float32)

    def loss(params):
        (_, logits), _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                  train=True, mutable=["batch_stats"])
        return jnp.sum(logits.astype(jnp.float32) ** 2)

    def streamed(p):
        return loss(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, p))

    def to_bf16(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))

    ls, gs = jax.jit(jax.value_and_grad(streamed))(v["params"])
    lr_, gr = jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(to_bf16, v["params"]))
    assert np.asarray(ls) == np.asarray(lr_)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(gs)[0],
                            jax.tree_util.tree_leaves(gr)):
        key = jax.tree_util.keystr(path)
        assert a.dtype == jnp.float32
        want = b if dtype == "bfloat16" and "conv" in key else to_bf16(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(want), err_msg=key)


def test_weight_stream_round_matches_jax(monkeypatch):
    """Two FedAVG rounds (smallcnn, 4 clients, one step each) of the port's
    ``Trainer`` with ``weight_stream=1`` and bfloat16 compute against the
    JAX package's ``Trainer`` from the same weights and batch plans, its
    ``make_local_round`` given ``weight_stream_dtype=bfloat16``. On the CPU
    the port's bfloat16 compute is float32 arithmetic, so the JAX side runs
    its float32 model: each step then runs float32 arithmetic on the
    parameters rounded to bfloat16 on both sides, and the float32 masters
    take gradients rounded to bfloat16 (the identity above). Client losses
    within rtol 1e-4 and every aggregated variable within atol 1e-4 (as the
    float32 FedAVG parity test). One step a client: after several, a
    master that the frameworks' float32 sums leave on two sides of a
    bfloat16 rounding boundary streams values one bfloat16 ulp apart, and
    that moves the gradients of later steps by far more than float32
    rounding does."""
    real = jrt.make_local_round
    monkeypatch.setattr(jrt, "make_local_round", functools.partial(
        lambda *a, **k: real(*a, **{**k, "weight_stream_dtype": jnp.bfloat16})))
    kw = dict(algorithm="fedavg", model="smallcnn", batch_size=16, base_lr=1e-3,
              n_clients=4, local_ep=1, rounds_warmup=2, eval_every=100, seed=3,
              p_pos=0.3, output_dir="", weight_stream=1)
    data = dict(name="synthetic", n_classes=4, image_size=32, synthetic_train_size=64,
                synthetic_test_size=8, augment_backend="normonly")
    jt = JTrainer(JConfig(**kw, compute_dtype="float32", data=JData(**data)),
                  use_mesh=False)
    tt = Trainer(Config(**kw, compute_dtype="bfloat16", data=DataConfig(**data)),
                 device="cpu")
    assert tt.weight_stream_dtype == torch.bfloat16
    assert tt.fd.n_local.tolist() == [16] * 4
    tt.global_vars = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
    for rnd in range(2):
        a, b = jt.run_round(rnd), tt.run_round(rnd)
        np.testing.assert_allclose(b.client_losses, a.client_losses, rtol=1e-4)
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jt.global_vars))
        assert set(want) == set(tt.global_vars)
        for n, w in want.items():
            np.testing.assert_allclose(tt.global_vars[n].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"round {rnd} {n}")


def test_weight_stream_round_equals_the_round_on_rounded_parameters():
    """A FedAVG round with ``weight_stream=1`` and bfloat16 compute (float32
    arithmetic on the CPU) against the same round without it on global
    parameters rounded to bfloat16 first: one step a client (16 images,
    batch 16), so the client losses and the running statistics are equal
    bit for bit."""
    out = []
    for ws in (1, 0):
        t = Trainer(_cfg(compute_dtype="bfloat16", weight_stream=ws), device="cpu")
        if not ws:
            pnames = {n for n, _ in t.model.named_parameters()}
            t.global_vars = {n: v.to(torch.bfloat16).float() if n in pnames else v
                             for n, v in t.global_vars.items()}
        assert (t.weight_stream_dtype is not None) == bool(ws)
        assert t.fd.n_local.tolist() == [16, 16]
        out.append(_round(t))
    assert torch.equal(out[0][0], out[1][0])
    for n, v in out[0][1].items():
        if "running" in n:
            assert torch.equal(v, out[1][1][n]), n


def test_weight_stream_is_the_identity_in_float32():
    out = []
    for ws in (0, 1):
        t = Trainer(_cfg(weight_stream=ws), device="cpu")
        assert t.weight_stream_dtype is None
        out.append(_round(t))
    assert torch.equal(out[0][0], out[1][0])
    for n, v in out[0][1].items():
        assert torch.equal(v, out[1][1][n]), n


@pytest.mark.parametrize("algo,get_fn,kw", [
    ("cbafed", cbafed._get_pseudo_fn, {}),
    ("fedirm", fedirm._get_relation_fn, {}),
    ("rofl", rofl._get_fns, {}),
    ("rscfed", rscfed._get_round_fn, {}),
    ("fedmlp", fedmlp._get_stage2_fn, dict(fedmlp=FedMLPConfig(mixup=1))),
])
def test_algorithms_hand_weight_stream_to_their_rounds(monkeypatch, algo, get_fn, kw):
    """The algorithms that build their own per-client round pass the
    trainer's weight type to it, as their JAX counterparts do."""
    t = Trainer(_cfg(algorithm=algo, compute_dtype="bfloat16", weight_stream=1, **kw),
                device="cpu")
    seen = []
    monkeypatch.setattr(rt, "make_local_round",
                        lambda *a, **k: seen.append(k.get("weight_stream_dtype")))
    get_fn(t)
    assert seen == [torch.bfloat16]


@pytest.mark.parametrize("kw,message", [
    (dict(algorithm="fedmlp", batched_global="on", weight_stream=1),
     "weight_stream=1 does not reach the lockstep engine"),
    (dict(client_stacking="on", weight_stream=1),
     "weight_stream=1 does not reach the stacked engine"),
    (dict(client_stacking="on", model="efficient_b0", dw_backend="taps"),
     "dw_backend='taps' does not reach the stacked forward"),
    (dict(client_stacking="on", model="efficient_b0", remat_stages="0"),
     "remat=0 remat_stages='0' do not reach the stacked forward"),
])
def test_trainer_warns_where_an_engine_never_sees_a_knob(caplog, kw, message):
    """As in the JAX package, the lockstep and stacked engines never receive
    ``weight_stream``, and the stacked forward neither the depthwise backend
    nor rematerialization: the ``Trainer`` says so."""
    with caplog.at_level(logging.WARNING, logger="fedmlp_tpu_torch"):
        Trainer(_cfg(compute_dtype="bfloat16", **kw), device="cpu")
    assert message in caplog.text


def test_weight_stream_with_remat_is_bit_for_bit():
    """Both knobs at once on B0: the recompute, which runs after the step's
    ``functional_call`` has put the module's own parameters back, reads the
    streamed ones that the forward read."""
    out = []
    for remat in (0, 1):
        t = Trainer(_cfg(model="efficient_b0", compute_dtype="bfloat16", weight_stream=1,
                         remat=remat), device="cpu")
        out.append(_round(t))
    assert torch.equal(out[0][0], out[1][0])
    for n, v in out[0][1].items():
        assert torch.equal(v, out[1][1][n]), n
