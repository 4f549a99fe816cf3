"""The channel-stacked forward (``models/stacked.py``) against K per-client
forwards and against the JAX package's ``stacked_apply``, and the stacked
engine (``client_stacking='on'``, ``fl_runtime.make_stacked_local_round``)
against the per-client loop.

Float32 on the CPU: smallcnn at 32 px and EfficientNet-B0 at 64 px, K=3
clients of different weights, B=4. The bounds of the JAX package's
tests/test_stacked.py (logits, features and new running statistics within
2e-4, gradients within 5e-4) and tests/test_stacked_round.py (FedAVG:
client losses rtol 1e-3 atol 1e-4, global variables rtol 1e-2 atol 1e-3;
FedMLP: the same losses, tags equal, variables rtol 5e-2 atol 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.models import build_model as jbuild
from fedmlp_tpu.models.stacked import stacked_apply as jstacked_apply
from fedmlp_tpu_torch.algos import fedavg as tfedavg
from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.models.stacked import stacked_apply, supports_stacking
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.train import Trainer
from fedmlp_tpu_torch.weights import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_variables import flax_shapes, numpy_variables

K, B, C = 3, 4, 5
TOL = dict(rtol=2e-4, atol=2e-4)


def _clients(name, image, normed_head=False, seed=0):
    """K modules of ``name`` whose weights and running statistics differ,
    and their client-stacked state dict."""
    models = []
    for k in range(K):
        m = init_model(build_model(name, C, normed_head=normed_head), seed)
        g = torch.Generator().manual_seed(100 + k)
        with torch.no_grad():
            for n, v in m.state_dict().items():
                noise = torch.randn(v.shape, generator=g)
                v.add_(0.1 * noise.abs() if "running" in n else 0.05 * noise * v.abs().mean())
        models.append(m)
    sv = {n: torch.stack([m.state_dict()[n] for m in models]) for n in models[0].state_dict()}
    return models, sv


def _x(image, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(K, B, 3, image, image)
                            .astype(np.float32))


@pytest.mark.parametrize("name,image,normed", [("smallcnn", 32, False),
                                               ("smallcnn", 32, True),
                                               ("efficient_b0", 64, False),
                                               ("efficient_b2", 64, True)])
def test_stacked_forward_matches_per_client_forwards(name, image, normed):
    """Eval and train mode: logits, features and (train) the new running
    statistics of every client as its own module's forward gives them; the
    gradients of a loss over all clients as each module's. B2 (width 1.1,
    depth 1.2) and the cosine head cover the other multipliers and head."""
    models, sv = _clients(name, image, normed)
    x = _x(image)
    assert supports_stacking(models[0])
    (f, lg), st = stacked_apply(models[0], sv, x, train=False)
    assert st is None and f.shape[:2] == lg.shape[:2] == (K, B)
    for k, m in enumerate(models):
        fk, lk = m.eval()(x[k])
        np.testing.assert_allclose(lg[k].numpy(), lk.detach().numpy(), **TOL)
        np.testing.assert_allclose(f[k].numpy(), fk.detach().numpy(), **TOL)

    y = torch.from_numpy((np.random.RandomState(1).rand(K, B, C) > 0.5).astype(np.float32))
    leaves = {n: v.clone().requires_grad_() for n, v in sv.items() if "running" not in n}
    (f, lg), st = stacked_apply(models[0], {**sv, **leaves}, x, train=True)
    (torch.nn.functional.logsigmoid(lg) * y).sum().backward()
    for k, m in enumerate(models):
        before = {n: v.clone() for n, v in m.state_dict().items()}
        fk, lk = m.train()(x[k])
        (torch.nn.functional.logsigmoid(lk) * y[k]).sum().backward()
        np.testing.assert_allclose(lg[k].detach().numpy(), lk.detach().numpy(), **TOL)
        np.testing.assert_allclose(f[k].detach().numpy(), fk.detach().numpy(), **TOL)
        stats = [n for n in before if "running" in n]
        assert sorted(st) == sorted(stats)
        for n in stats:
            np.testing.assert_allclose(st[n][k].numpy(), m.state_dict()[n].numpy(), **TOL,
                                       err_msg=n)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(leaves[n].grad[k].numpy(), p.grad.numpy(),
                                       rtol=5e-4, atol=5e-4, err_msg=n)


@pytest.mark.parametrize("name,image", [("smallcnn", 32), ("efficient_b0", 64)])
def test_stacked_forward_matches_jax_stacked_apply(name, image):
    """The same K clients' weights in both packages (flax variables through
    ``weights.py``), the same views: logits, features and the new running
    statistics within 2e-4, in eval and in train mode. The weights start
    from variables drawn with numpy in flax's shapes
    (tests/torch_variables.py)."""
    jm = jbuild(name, C, compute_dtype=jnp.float32)
    base = numpy_variables(flax_shapes(jm, image, train=False), 0)
    rs = np.random.RandomState(2)
    jvars = jax.tree_util.tree_map(
        lambda v: np.stack([np.asarray(v) * (1 + 0.05 * rs.randn(*v.shape)).astype(np.float32)
                            for _ in range(K)]), base)
    x = _x(image, 3)
    jx = jnp.asarray(x.numpy().transpose(0, 1, 3, 4, 2))
    tvars = [from_jax_variables(jax.tree_util.tree_map(lambda v, k=k: v[k], jvars))
             for k in range(K)]
    sv = {n: torch.stack([t[n] for t in tvars]) for n in tvars[0]}
    model = build_model(name, C)
    for train in (False, True):
        (jf, jl), jst = jax.jit(lambda v, xx, t=train: jstacked_apply(jm, v, xx, train=t))(
            jvars, jx)
        (f, lg), st = stacked_apply(model, sv, x, train=train)
        np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), **TOL)
        if train:
            for k in range(K):
                want = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
                    lambda v, k=k: np.asarray(v[k]), jst)})
                assert sorted(want) == sorted(st)
                for n, w in want.items():
                    np.testing.assert_allclose(st[n][k].numpy(), w.numpy(), **TOL,
                                               err_msg=n)


def test_stacked_draws_are_per_sample_and_client():
    """B0 with drop-connect and dropout on: a stacked train forward of one
    client with a generator equals the module's forward with a generator in
    the same state (drop-connect draws [B, K] a block, dropout [B, K, D]),
    and leaves the generator where the module leaves it; at K=3 it draws K
    times as many numbers."""
    models, sv = _clients("efficient_b0", 64)
    x = _x(64)
    m = models[0].train()
    one = {n: v[:1] for n, v in sv.items()}
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    (f, lg), _ = stacked_apply(m, one, x[:1], train=True, generator=g1)
    fk, lk = m(x[0], generator=g2)
    np.testing.assert_allclose(lg[0].detach().numpy(), lk.detach().numpy(), **TOL)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert (f[0] == 0).any()  # dropout zeroed features
    g = torch.Generator().manual_seed(5)
    stacked_apply(m, sv, x, train=True, generator=g)
    blocks = [getattr(m, n) for n in m.block_names]
    n_one = B * sum(b.drop_rate > 0 and b.stride == 1 and b.in_ch == b.out_ch
                    for b in blocks) + B * 1280  # a client's draws
    ref = torch.Generator().manual_seed(5)
    torch.rand(K * n_one, generator=ref)
    assert torch.equal(g.get_state(), ref.get_state())


def _cfg(**kw):
    base = dict(algorithm="fedavg", model="smallcnn", batch_size=8, base_lr=1e-3,
                n_clients=4, local_ep=1, rounds_warmup=4, eval_every=10_000, seed=7,
                p_pos=1.0, compute_dtype="float32", output_dir="",
                data=DataConfig(name="synthetic", n_classes=C, image_size=32,
                                synthetic_train_size=96, synthetic_test_size=16,
                                augment_backend="normonly"))
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("algo", ["fedavg", "fedmlp"])
def test_stacked_round_matches_the_per_client_loop(algo):
    """FedAVG over 3 rounds; FedMLP over 2 stage-1 and 2 stage-2 rounds
    (its tags must evolve identically)."""
    kw = {} if algo == "fedavg" else dict(
        algorithm="fedmlp", p_pos=0.0, fedmlp=FedMLPConfig(
            rounds_stage1=2, clean_threshold=0.2, noise_threshold=0.2))
    n = 3 if algo == "fedavg" else 4
    runs = {}
    for engine, mode in (("mapped", "off"), ("stacked", "on")):
        t = Trainer(_cfg(client_stacking=mode, **kw), device="cpu")
        assert t.engine == engine
        runs[engine] = (t, [t.run_round(r).client_losses for r in range(n)])
    (tm, lm), (ts, ls) = runs["mapped"], runs["stacked"]
    np.testing.assert_allclose(ls, lm, rtol=1e-3, atol=1e-4)
    tol = dict(rtol=1e-2, atol=1e-3) if algo == "fedavg" else dict(rtol=5e-2, atol=5e-3)
    for name, v in tm.global_vars.items():
        np.testing.assert_allclose(ts.global_vars[name].numpy(), v.numpy(), **tol,
                                   err_msg=name)
    if algo == "fedmlp":
        np.testing.assert_array_equal(ts.server_state["tags"], tm.server_state["tags"])
        assert (ts.server_state["tags"] > 0).any()


def test_stacked_round_holds_a_padding_client_bitwise():
    """Client 1 takes a real step, then a step that is all padding, then a
    real step: its parameters, batch-norm statistics, Adam moments and
    count hold through the padding step, so it ends exactly where a plan of
    its two real steps alone leaves it (its count decides Adam's bias
    correction; its moments the second step's update)."""
    rng = np.random.RandomState(0)
    sizes, Bp = (12, 8, 4), 4
    n = sum(sizes)
    starts = np.cumsum((0,) + sizes)
    users = {k: list(range(starts[k], starts[k + 1])) for k in range(K)}
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    images = rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    fd = rt.build_federated_data(images, targets, users, np.zeros_like(targets, bool),
                                 [[k] for k in range(K)], device="cpu")
    pos, pos_valid, _ = rt.make_batch_plan(np.random.RandomState(0), fd.valid.numpy(),
                                           Bp, 1)
    assert pos_valid[:, 1].any(1).tolist() == [True, True, False]
    pos[1:, 1] = pos[[2, 1], 1]  # client 1: real, padding, real
    pos_valid[1:, 1] = pos_valid[[2, 1], 1]
    data = {"images": fd.images, "idx": fd.idx, "ctx": {"loss_w": fd.loss_w}}
    gv = dict(init_model(build_model("smallcnn", C), 1).state_dict())
    fn = rt.make_stacked_local_round(build_model("smallcnn", C), tfedavg.stacked_loss_fn,
                                     lr=1e-3, batch_size=Bp, mean=(0.5,) * 3,
                                     std=(0.25,) * 3, augment_backend="normonly")

    def run(steps):
        plan = {"pos": pos[steps], "pos_valid": pos_valid[steps],
                "sample": {"labels": fd.obs_targets}}
        return fn(gv, data, plan, {}, torch.Generator())

    full, lf, _ = run([0, 1, 2])
    short, ls, _ = run([0, 2])
    assert lf[1] == ls[1]
    for name, v in full["vars"].items():
        assert torch.equal(v[1], short["vars"][name][1]), name
    for name, v in gv.items():
        assert not torch.equal(full["vars"][name][1], v) or "running" in name, name


def test_stacked_round_hoists_its_views(monkeypatch):
    """With ``hoist_augment`` a stacked round of at most 4096 view images
    makes its views before its first step, in one ``pre_augment_views``
    call, as the per-client loop does; 'normonly' views are the same either
    way, so the rounds equal the in-step ones bit for bit."""
    calls = []
    real = rt.pre_augment_views

    def counting(imgs, *a, **kw):
        calls.append(tuple(imgs.shape[:3]))
        return real(imgs, *a, **kw)

    monkeypatch.setattr(rt, "pre_augment_views", counting)
    runs = []
    for hoist in (1, 0):
        t = Trainer(_cfg(client_stacking="on", hoist_augment=hoist), device="cpu")
        runs.append((t, [t.run_round(r).client_losses for r in range(2)]))
    assert calls == [(3, 4, 8)] * 2  # S·K·B = 96 images, one call a round
    (th, lh), (ts, ls) = runs
    assert lh == ls
    for name, v in th.global_vars.items():
        assert torch.equal(v, ts.global_vars[name]), name
