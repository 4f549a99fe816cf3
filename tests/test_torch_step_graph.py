"""The per-client loop's static step (``parallel/step_graph.py``), which a
CUDA graph captures on the card.

On the CPU nothing is captured: the static step (the round's tables at fixed
addresses, the step picked by its device pair) runs eagerly every step, the
loop's own Adam after it, and the round holds bit for bit against
the eager loop (forced by an unmarked wrapper of the loss) on FedMLP stage 1
and FedAvg with the 'fused' weak view's random draws, a ragged last batch and
a skipped padding step. The paths that must stay eager (a teacher,
``post_step``, weight streaming, an unmarked loss, views hoisted before the
round) never build it.

On the card (``cuda``; skip without one) a small ResNet-18 FedMLP round: the
graphed step's views and draws equal the eager step's bit for bit from the
same generator state; two graphed rounds equal two rounds of the static step
run eagerly and two rounds of the eager loop bit for bit; replays synchronize
nothing; the optimizer's hooks fire on every step; the counters count the
replays and every replayed B1 launch, and the profiler sees the graph's
kernels. A small Swin's graphed rounds (attention, stochastic depth) count
the attention calls and rows that the eager loop counts and equal its rounds
bit for bit. ResNet-18's graphed rounds count the channels-last forwards
that the eager loop counts, equal its rounds bit for bit, and run no cuDNN
layout transpose and only the channels-last batch-norm and NHWC max-pool
kernels. This file imports torch and the port alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py -q
"""

import numpy as np
import pytest
import torch

from fedmlp_tpu_torch.algos import fedavg as tfedavg
from fedmlp_tpu_torch.algos import fedmlp as tfedmlp
from fedmlp_tpu_torch.models import build_model, init_model
from fedmlp_tpu_torch.ops import warp as W
from fedmlp_tpu_torch.parallel import fl_runtime as rt
from fedmlp_tpu_torch.parallel import step_graph as G
from fedmlp_tpu_torch.utils import profiling as P
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

C = 4
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _federation(device, sizes, B, img, seed=0):
    """(data, plan) of clients with ``sizes`` images each, batch ``B``: a
    client whose size B does not divide has a ragged last batch, and one
    with fewer batches than the most pads its last steps."""
    rng = np.random.RandomState(seed)
    K, n = len(sizes), sum(sizes)
    images = rng.randint(0, 256, (n, img, img, 3), dtype=np.uint8)
    starts = np.cumsum([0] + list(sizes))
    users = {k: list(range(starts[k], starts[k + 1])) for k in range(K)}
    targets = (rng.rand(n, C) > 0.5).astype(np.float32)
    fd = rt.build_federated_data(images, targets, users, np.zeros_like(targets, bool),
                                 [[k % C] for k in range(K)], device=device)
    pos, pos_valid, _ = rt.make_batch_plan(np.random.RandomState(seed), fd.valid.cpu().numpy(),
                                           B, 1)
    active = fd.active.float()
    ctx = {"active": active, "negative": 1.0 - active, "loss_w": fd.loss_w}
    data = {"images": fd.images, "idx": fd.idx, "ctx": ctx}
    plan = {"pos": pos, "pos_valid": pos_valid, "sample": {"labels": fd.obs_targets}}
    return data, plan


def _rounds(model_name, loss_fn, view_mode, data, plan, device, n_rounds=2, img=32,
            compute_dtype="float32", seed=5, lr=1e-3, arch=None, **kw):
    """``n_rounds`` calls of a fresh ``make_local_round`` from the same
    weights and generator seed, each round from the first client's
    variables of the one before → ([(vars, losses)], the round function).
    ``arch``: the model constructor's own arguments."""
    needs_global = view_mode == "dual"
    extra = kw.pop("_extra", lambda: None)

    def build():
        return build_model(model_name, C, image_size=img, **(arch or {}))

    model = build().to(device)
    gv = {n: v.to(device) for n, v in init_model(build(), 3).state_dict().items()}
    fn = rt.make_local_round(
        model, loss_fn, lr=lr, batch_size=plan["pos"].shape[2], mean=MEAN, std=STD,
        view_mode=view_mode, needs_global=needs_global, augment_backend="fused",
        compute_dtype=compute_dtype,
        global_model=build().to(device) if needs_global else None, **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for r in range(n_rounds):
        with P.round_record(r):
            res, losses, aux = fn(gv, data, plan, {"rnd": float(r)}, gen, extra())
        assert aux == {}
        out.append((res["vars"], losses))
        gv = rt.client_vars(res["vars"], 0)
    return out, fn


def _unmarked(loss_fn):
    """``loss_fn`` without the ``graph_safe`` mark: its rounds run the eager
    loop."""
    def loss(*a, **kw):
        return loss_fn(*a, **kw)
    return loss


def _assert_bitwise(a, b):
    for (va, la), (vb, lb) in zip(a, b):
        assert torch.equal(la, lb)
        assert list(va) == list(vb)
        for n in va:
            assert torch.equal(va[n], vb[n]), n


@pytest.fixture
def static_steps(monkeypatch):
    """A record of the static steps built and of their step calls."""
    built, steps = [], []
    init, step = G.StaticStep.__init__, G.StaticStep.step

    def spy_init(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    def spy_step(self, k, s, train):
        steps.append((k, s))
        return step(self, k, s, train)

    monkeypatch.setattr(G.StaticStep, "__init__", spy_init)
    monkeypatch.setattr(G.StaticStep, "step", spy_step)
    return built, steps


@pytest.mark.parametrize("algo", ["fedmlp", "fedavg"])
def test_static_step_equals_the_eager_loop_bitwise(static_steps, algo):
    """Two rounds of K=3 clients (9, 5 and 2 images at B=4: ragged last
    batches, and client 2 pads from its second step on), the 'fused' weak
    views drawing from the round's generator: the static step's losses and
    variables are the eager loop's bit for bit, and it ran every live step
    in the loop's order."""
    loss_fn, view_mode = {"fedmlp": (tfedmlp.loss_fn, "dual"),
                          "fedavg": (tfedavg.loss_fn, "single")}[algo]
    assert G.is_graph_safe(loss_fn)
    data, plan = _federation("cpu", [9, 5, 2], 4, 32)
    live = plan["pos_valid"].any(2)
    assert live[0, 2] and not live[1:, 2].any()
    built, steps = static_steps
    static, _ = _rounds("smallcnn", loss_fn, view_mode, data, plan, "cpu")
    assert len(built) == 1
    order = [(k, s) for k in range(3) for s in range(live.shape[0]) if live[s, k]]
    assert steps == order * 2
    assert built[0].graph is None and not built[0].launches  # nothing captured on the CPU
    eager, _ = _rounds("smallcnn", _unmarked(loss_fn), view_mode, data, plan, "cpu")
    assert len(built) == 1
    _assert_bitwise(static, eager)


def _teacher_kw():
    def extra():
        return {"teacher": rt.broadcast_to_clients(
            dict(init_model(build_model("smallcnn", C), 4).state_dict()), 3)}
    return dict(teacher_decay=0.9, teacher_model=build_model("smallcnn", C), _extra=extra)


def _post_step_kw():
    def post_step(cstate, aux, sample, svalid, ctx):
        return {"seen": cstate["seen"] + svalid.float().sum()}

    def extra():
        return {"cstate": {"seen": torch.zeros(3)}}
    return dict(post_step=post_step, _extra=extra)


@G.graph_safe
def _loss_with_state(model, views, sample, svalid, ctx, generator, scalars, cstate):
    return tfedmlp.loss_fn(model, views, sample, svalid, ctx, generator, scalars)


@pytest.mark.parametrize("case", ["teacher", "post_step", "weight_stream", "unmarked",
                                  "hoisted"])
def test_eager_only_paths_never_take_the_static_step(static_steps, case):
    """A teacher, ``post_step`` (with per-client state), weight streaming, a
    loss not marked ``graph_safe`` and views made before the round keep the
    eager loop: no static step is built, and the rounds are those of the
    unmarked loss bit for bit."""
    loss_fn = tfedmlp.loss_fn
    kw = {"teacher": _teacher_kw, "post_step": _post_step_kw,
          "weight_stream": lambda: dict(weight_stream_dtype=torch.bfloat16),
          "unmarked": dict, "hoisted": lambda: dict(hoist_augment=True)}[case]()
    if case == "post_step":
        loss_fn = _loss_with_state
    elif case == "unmarked":
        loss_fn = tfedmlp.loss_fn_viewcat
    data, plan = _federation("cpu", [9, 5, 2], 4, 32)

    def run(loss_fn):
        return _rounds("smallcnn", loss_fn, "dual", data, plan, "cpu", **kw)[0]

    built, steps = static_steps
    on = run(loss_fn)
    assert built == [] and steps == []
    _assert_bitwise(on, run(_unmarked(loss_fn)))


def test_a_round_that_does_not_fit_the_captured_buffers_runs_eagerly(static_steps):
    """Once a graph holds the static step's buffers, a round with other
    shapes (here another step count), another images table or another
    generator is refused by ``load_round`` and runs the eager loop; before
    a capture the buffers are made anew."""
    data, plan = _federation("cpu", [9, 5, 2], 4, 32)
    data2, plan2 = _federation("cpu", [13, 5, 2], 4, 32)
    built, _ = static_steps
    _, fn = _rounds("smallcnn", tfedmlp.loss_fn, "dual", data, plan, "cpu", n_rounds=1)
    st = built[0]
    pos = torch.as_tensor(plan["pos"])
    valid = torch.as_tensor(plan["pos_valid"])
    gen = st.generator
    tables = dict(images=data["images"], idx=data["idx"], pos=pos, valid=valid,
                  sample=plan["sample"], ctx=data["ctx"])
    assert st.load_round(**tables, generator=gen)
    st.graph, st.grads = object(), [q.grad for q in st.params]  # as after a capture
    assert st.load_round(**tables, generator=gen)
    assert not st.load_round(**{**tables, "pos": torch.as_tensor(plan2["pos"]),
                                "valid": torch.as_tensor(plan2["pos_valid"])}, generator=gen)
    assert not st.load_round(**{**tables, "images": data["images"].clone()}, generator=gen)
    assert not st.load_round(**tables, generator=torch.Generator().manual_seed(1))
    gv0 = dict(init_model(build_model("smallcnn", C), 3).state_dict())
    gv = rt.client_vars(fn(gv0, data2, plan2, {}, gen)[0]["vars"], 0)
    assert set(gv) == set(gv0)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured on the card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_rounds_on_the_card(card, monkeypatch):
    """ResNet-18 at 64 px, FedMLP stage 1 in bf16 at the cells' lr 3e-6, K=2
    clients of 20 and 12 images at B=8 (client 1 ragged, then a padding
    step): 5 live steps a round, the first ``WARMUP_STEPS`` of round 0
    eager, then one capture.

    * Round 1, profiled: every step a replay; the replays and the eager Adam
      after them synchronize nothing (sync debug mode 'error'); Adam's step
      hooks fire once a step; B1's launch counter counts 2 launches a
      replayed step, as many as the profiler finds ``fused_warp_kernel``.
    * A replay's views equal the eager views from the same generator state
      bit for bit, and the replay leaves the generator where the eager
      step's draws would (ResNet-18 draws nothing else).
    * The two graphed rounds equal, bit for bit, two rounds of the static
      step run eagerly (never captured): the graph replays that step's
      kernels on the same buffers.
    * They equal two rounds of the eager loop bit for bit too: the static
      step gathers the same values, and the same Adam runs after each step.
      (A gap is printed before the comparison fails.)"""
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    from torch.profiler import ProfilerActivity, profile

    data, plan = _federation(card, [20, 12], 8, 64)
    live = int(plan["pos_valid"].any(2).sum())
    assert live == 5
    built = []
    init, step = G.StaticStep.__init__, G.StaticStep.step
    views_seen = {}

    def spy_init(self, params, *, augment_views, **kw):
        def views(imgs, gen):
            out = augment_views(imgs, gen)
            views_seen.update(out, imgs=imgs, fn=augment_views)
            return out
        built.append(self)
        init(self, params, augment_views=views, **kw)

    strict = []

    def spy_step(self, k, s, train):
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return step(self, k, s, train)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(G.StaticStep, "__init__", spy_init)
    monkeypatch.setattr(G.StaticStep, "step", spy_step)
    kw = dict(compute_dtype="bfloat16", img=64, lr=3e-6)
    P.reset()
    graphed, fn = _rounds("resnet18", tfedmlp.loss_fn, "dual", data, plan, card,
                          n_rounds=1, **kw)
    (st,) = built
    assert st.graph is not None
    rec0 = P.HISTORY[-1]["counters"]
    assert rec0[P.GRAPH_CAPTURES] == 1
    assert rec0[P.GRAPH_STEPS] == live - G.WARMUP_STEPS
    # round 1, profiled, strict
    strict.append(True)
    W.reset_launch_counts()
    gv = rt.client_vars(graphed[0][0], 0)
    gen = st.generator
    hooked = []

    def pre(opt, args, kwargs):  # Adam's step, strict as the replays
        hooked.append(opt)
        torch.cuda.set_sync_debug_mode("error")

    handles = [register_optimizer_step_pre_hook(pre), register_optimizer_step_post_hook(
        lambda opt, args, kwargs: torch.cuda.set_sync_debug_mode("default"))]
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with P.round_record(1):
                res, losses, _ = fn(gv, data, plan, {"rnd": 1.0}, gen)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for h in handles:
            h.remove()
    assert len(hooked) == live
    graphed.append((res["vars"], losses))
    rec1 = P.HISTORY[-1]["counters"]
    assert rec1[P.GRAPH_STEPS] == rec1[P.STEPS] == live
    assert P.GRAPH_CAPTURES not in rec1
    assert W.LAUNCH_COUNTS["fused_warp_normalize"] == 2 * live
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "fused_warp_kernel" in e.name()]
    assert len(kernels) == 2 * live
    strict.clear()

    # a replay's views against the eager views from the same generator state
    state = gen.get_state()
    st.step(1, 1, None)  # a replay: the step's own work is in the graph
    torch.cuda.synchronize()
    after_replay = gen.get_state()
    got = {n: views_seen[n].clone() for n in ("x1", "x2")}
    gen.set_state(state)
    imgs = data["images"][data["idx"][1, torch.as_tensor(plan["pos"][1, 1], device=card)]]
    assert torch.equal(imgs, views_seen["imgs"])
    want = views_seen["fn"](imgs, gen)
    for n in ("x1", "x2"):
        assert torch.equal(got[n], want[n]), n
    assert torch.equal(gen.get_state(), after_replay)

    monkeypatch.setattr(G, "WARMUP_STEPS", 10**9)
    static, _ = _rounds("resnet18", tfedmlp.loss_fn, "dual", data, plan, card,
                        n_rounds=2, **kw)
    assert built[-1].graph is None
    _assert_bitwise(graphed, static)

    eager, fn_eager = _rounds("resnet18", _unmarked(tfedmlp.loss_fn), "dual", data, plan,
                              card, n_rounds=2, **kw)
    for r, ((va, la), (vb, lb)) in enumerate(zip(graphed, eager)):
        differ = [n for n in vb if not torch.equal(va[n], vb[n])]
        print(f"round {r}: graphed against the eager loop, losses {la.tolist()} and "
              f"{lb.tolist()}, {len(differ)} of {len(vb)} variables differ {differ[:4]}")
    _assert_bitwise(graphed, eager)

    # a round on another generator (``load_round`` refuses it: the eager
    # loop), then one on the captured graph's again, whose replays write the
    # gradients that Adam reads; against the same two rounds of the eager loop
    gv, state = rt.client_vars(eager[-1][0], 0), gen.get_state()
    after = []
    for f in (fn, fn_eager):
        gen.set_state(state)
        outs = []
        for r, g in ((2, torch.Generator(device=card).manual_seed(9)), (3, gen)):
            with P.round_record(r):
                res, losses, _ = f(outs[-1][2] if outs else gv, data, plan, {}, g)
            outs.append((res["vars"], losses, rt.client_vars(res["vars"], 0)))
            if f is fn:
                assert P.HISTORY[-1]["counters"].get(P.GRAPH_STEPS, 0) == (r == 3) * live
        after.append([o[:2] for o in outs])
    _assert_bitwise(*after)


@pytest.mark.cuda
def test_graphed_swin_rounds_count_and_equal_the_eager_loop(card):
    """A small Swin (width 16, depths (2, 2, 2, 2), heads (1, 1, 2, 2), window
    4: shifted and masked windows, a padded stage, stochastic depth to 0.5)
    at 64 px, FedMLP stage 1 in bf16, K=2 clients of 20 and 12 images at B=8:
    two graphed rounds, profiled, against two rounds of the eager loop. Each
    round counts the same attention calls and rows (the capture's counts
    undone, each replay's added); losses and variables are equal bit for bit;
    the profiler finds the pinned memory-efficient backend's kernels, one
    forward launch a counted call (their names are printed)."""
    from torch.profiler import ProfilerActivity, profile

    data, plan = _federation(card, [20, 12], 8, 64)
    live = int(plan["pos_valid"].any(2).sum())
    kw = dict(compute_dtype="bfloat16", img=64, lr=3e-6,
              arch=dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2), window=4))
    attn = (P.ATTN_CALLS_GRAD, P.ATTN_ROWS_GRAD, P.ATTN_CALLS_NOGRAD, P.ATTN_ROWS_NOGRAD)
    counted = []
    P.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graphed, _ = _rounds("swin_b", tfedmlp.loss_fn, "dual", data, plan, card, **kw)
        torch.cuda.synchronize()
    counted.append([{n: r["counters"].get(n, 0) for n in attn} for r in P.HISTORY])
    assert P.HISTORY[-1]["counters"][P.GRAPH_STEPS] == live
    P.reset()
    eager, _ = _rounds("swin_b", _unmarked(tfedmlp.loss_fn), "dual", data, plan, card, **kw)
    counted.append([{n: r["counters"].get(n, 0) for n in attn} for r in P.HISTORY])
    print(f"attention counters a round, graphed {counted[0]}, eager {counted[1]}")
    assert counted[0] == counted[1]
    assert counted[1][0][P.ATTN_CALLS_GRAD] == live * 2 * 8  # two trained views, 8 blocks
    names = [e.name() for e in prof.profiler.kineto_results.events() if "fmha" in e.name()]
    print("attention kernels:", sorted({n[:120] for n in names}))
    forward = sum(1 for n in names if "fmha_cutlassF" in n)
    assert forward == sum(c[P.ATTN_CALLS_GRAD] + c[P.ATTN_CALLS_NOGRAD] for c in counted[0])
    assert any("fmha_cutlassB" in n for n in names)
    _assert_bitwise(graphed, eager)


@pytest.mark.cuda
def test_graphed_resnet18_rounds_run_channels_last(card):
    """ResNet-18 at 64 px, FedMLP stage 1 in bf16, K=2 clients of 20 and 12
    images at B=8: two graphed rounds, profiled, against two rounds of the
    eager loop. Each round counts the same ``fedmlp.nhwc_forwards`` (the
    capture's count undone, each replay's added), one a forward; losses and
    variables are equal bit for bit. In the profile no cuDNN layout
    transpose (``nchwToNhwcKernel``, ``nhwcToNchwKernel``) runs, every ATen
    batch-norm kernel is a ``channels_last`` one and the max-pool runs its
    NHWC kernels (the names are printed)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    data, plan = _federation(card, [20, 12], 8, 64)
    live = int(plan["pos_valid"].any(2).sum())
    kw = dict(compute_dtype="bfloat16", img=64, lr=3e-6)
    counted = []
    P.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graphed, _ = _rounds("resnet18", tfedmlp.loss_fn, "dual", data, plan, card, **kw)
        torch.cuda.synchronize()
    counted.append([r["counters"].get(P.NHWC_FORWARDS, 0) for r in P.HISTORY])
    assert P.HISTORY[-1]["counters"][P.GRAPH_STEPS] == live
    P.reset()
    eager, _ = _rounds("resnet18", _unmarked(tfedmlp.loss_fn), "dual", data, plan, card, **kw)
    counted.append([r["counters"].get(P.NHWC_FORWARDS, 0) for r in P.HISTORY])
    print(f"fedmlp.nhwc_forwards a round, graphed {counted[0]}, eager {counted[1]}")
    assert counted[0] == counted[1] and min(counted[1]) >= 2 * live
    _assert_bitwise(graphed, eager)

    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA}
    layout = sorted(n[:120] for n in names if re.search("batch_norm|max_pool|nchw|nhwc", n,
                                                        re.IGNORECASE))
    print("layout kernels:", layout)
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]
    bn = [n for n in names if re.search(r"batch_norm_\w*kernel", n)]
    assert bn and all("channels_last" in n for n in bn), bn
    pools = [n for n in names if "max_pool" in n]
    assert pools and all("nhwc" in n for n in pools), pools
