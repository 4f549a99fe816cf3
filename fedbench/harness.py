"""One run of a cell: set-up, the measured window, the traced round, the
check against the plain reference.

Set-up builds the program's ``Trainer`` on the benchmark's inputs and hands
it the benchmark's weights, then drives it through the traffic's
``setup_rounds`` rounds with ``Trainer.run_round``, the window's own call:
they warm up every shape the window uses, and they are the rounds the
reference follows. The window then calls ``run_round`` round after round,
each closed by a synchronize, until ``seconds`` have passed, and ends at the
first round boundary after that. With ``trace`` one round in the middle of
the window runs under ``torch.profiler``; the rates come from the others.
Once the window has closed and the program is freed, the reference repeats
the set-up rounds from the same inputs, and ``compare`` judges the program's.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from pathlib import Path

import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
from torch.profiler import record_function

from fedbench import cell as C
from fedbench import compare, peaks, trace
from fedbench.reference import fedmlp as ref_fedmlp

METRICS_DIR = "fedbench/metrics"
# ImageNet's normalization, every view's (the FedMLP reference's transforms)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _mark(device: torch.device):
    """A point on the device's stream (a CUDA event), or the host's clock."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _span_s(a, b) -> float:
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def bench_trainer_class():
    """``Trainer`` with the harness's spans around ``local_pass`` and
    ``aggregate`` (both reached through the trainer by every algorithm's
    round) for the profiler, and each local pass's span on the device's
    stream in ``local_marks`` (events, so the program gains no
    synchronize), read once its round has closed."""
    from fedmlp_tpu_torch.train import Trainer

    class BenchTrainer(Trainer):
        def __init__(self, *args, **kw):
            self.local_marks = []
            super().__init__(*args, **kw)

        def local_pass(self, *args, **kw):
            with record_function(trace.LOCAL):
                start = _mark(self.device)
                try:
                    return super().local_pass(*args, **kw)
                finally:
                    self.local_marks.append((start, _mark(self.device)))

        def aggregate(self, *args, **kw):
            with record_function(trace.AGGREGATE):
                return super().aggregate(*args, **kw)

    return BenchTrainer


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round(trainer, rnd: int, device) -> list:
    """One ``run_round``, closed by a synchronize → the clients' losses."""
    rec = trainer.run_round(rnd)
    sync(device)
    return rec.client_losses


def local_seconds(trainer) -> float:
    """Seconds of the local passes since the last call (their rounds closed)."""
    marks, trainer.local_marks = trainer.local_marks, []
    return sum(_span_s(a, b) for a, b in marks)


def program_setup(cell: C.Cell, seed: int, device, patch=None):
    """(trainer, inputs, outputs of the set-up rounds). ``inputs``: the data,
    the initial weights; ``outputs``: {'losses', 'first_grad', 'weights'} as
    ``compare.readings`` takes them. ``patch(trainer)`` may replace parts of
    the program before the first round (the tests' planted faults)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(C.program_seed(seed))
    data = C.make_data(cell, gen, device)
    weights = C.reference_model(cell).init_weights(cell.config["n_classes"], gen, device)
    train_ds, test_ds = C.datasets(cell, data)
    trainer = bench_trainer_class()(C.build_config(cell, seed), train_ds=train_ds,
                                    test_ds=test_ds, dict_users=data["dict_users"],
                                    device=device)
    have = {n: tuple(t.shape) for n, t in trainer.global_vars.items()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        raise ValueError(f"the program's variables are not the reference model's: "
                         f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    trainer.global_vars = {n: t.clone() for n, t in weights.items()}
    if patch is not None:
        patch(trainer)
    names = [n for n, _ in trainer.model.named_parameters()]
    first = {}

    def grab(opt, args, kwargs):  # the first step's gradient, as Adam gets it
        if not first:
            first.update({n: p.grad.detach().clone()
                          for n, p in zip(names, opt.param_groups[0]["params"])
                          if p.grad is not None})

    handle = register_optimizer_step_pre_hook(grab)
    losses = []
    try:
        for rnd in range(cell.traffic["setup_rounds"]):
            losses.append(_round(trainer, rnd, device))
            handle.remove()
    finally:
        handle.remove()
    outputs = {"losses": losses, "first_grad": first,
               "weights": {n: t.detach().clone() for n, t in trainer.global_vars.items()}}
    return trainer, {"data": data, "weights": weights}, outputs


def reference_rounds(cell: C.Cell, seed: int, inputs: dict, *, quant: bool = False,
                     fault: str | None = None) -> dict:
    """The plain reference over the set-up rounds (``quant``: the control,
    fp8 operands; ``fault``: a planted fault, ``ref_fedmlp.FAULTS``)."""
    c, t = cell.config, cell.traffic
    if t["algorithm"] != "fedmlp" or c["p_pos"] != 0.0:
        raise NotImplementedError("the reference runs FedMLP at p_pos 0")
    data = inputs["data"]
    with torch.autocast(data["images"].device.type, enabled=False):
        return ref_fedmlp.rounds(
            C.reference_model(cell), inputs["weights"], data["images"], data["labels"],
            data["dict_users"], seed=C.program_seed(seed), rounds=t["setup_rounds"],
            rounds_stage1=t["fedmlp"]["rounds_stage1"], batch_size=c["batch_size"],
            local_ep=c["local_ep"], lr=c["base_lr"], annotation_num=c["annotation_num"],
            mean=MEAN, std=STD, quant=quant, fault=fault)


def round_flops(cell: C.Cell) -> float:
    """Model FLOPs of one window round: each valid image's trained forwards
    (F + a 2F backward each), frozen-global forwards and harvest forwards (F
    each), as the traffic counts them."""
    c, f = cell.config, cell.traffic["per_image"]
    F = C.flop_counter(cell).forward_flops(c["image_size"], c["n_classes"])
    per_image = 3 * F * f["trained"] + F * (f["frozen"] + f["harvest"])
    return per_image * C.images_per_round(cell)


def reader_path(name: str, root: Path) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or, where a
    metric is split by cells (``mfu.b0`` beside ``mfu``), the reader of the
    name before its first dot."""
    path = root / METRICS_DIR / f"{name}.py"
    return path if path.exists() else root / METRICS_DIR / f"{name.split('.')[0]}.py"


def read_metrics(rec: dict, names, root: Path) -> dict:
    out = {}
    for name, unit in names:
        value = C.load_file_module(reader_path(name, root)).read(rec)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def run_cell(cell: C.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, metrics=(), patch=None) -> dict:
    """One run → the result line's fields. ``metrics``: [(name, unit)] of the
    cell's per-layer metrics, read when ``traced``."""
    from fedmlp_tpu_torch.ops import warp as program_warp

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from fedmlp_tpu_torch.ops import _build
        _build.build_all()  # every kernel at once; a built one is reused
    trainer, inputs, prog = program_setup(cell, seed, device, patch)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    rnd, failed, rounds, rec = cell.traffic["setup_rounds"], 0, [], None
    local_seconds(trainer)  # the set-up rounds' spans
    t0 = time.perf_counter()
    while True:
        profile = traced and rec is None and (time.perf_counter() - t0 >= seconds / 2)
        launches = program_warp.LAUNCH_COUNTS["fused_warp_normalize"]
        a = time.perf_counter()
        try:
            if profile:
                rec = _traced_round(trainer, rnd, device, cell)
                losses = rec.pop("losses")
                rec["warp"]["launches"] = (program_warp.LAUNCH_COUNTS["fused_warp_normalize"]
                                           - launches)
            else:
                losses = _round(trainer, rnd, device)
        except (RuntimeError, ValueError) as err:
            print(f"fedbench: round {rnd} raised {type(err).__name__}: {err}", flush=True)
            losses = [math.nan]
        b = time.perf_counter()
        print(f"fedbench: round {rnd} {b - a:.6f} s{' traced' if profile else ''}", flush=True)
        ok = all(map(math.isfinite, losses))
        failed += not ok
        rounds.append((b - a, profile, local_seconds(trainer) if ok else 0.0))
        rnd += 1
        if not ok or (b - t0 >= seconds and (rec is not None or not traced)):
            break
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"attempted": len(rounds), "failed": failed,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    if traced and rec is None:  # a round failed before the traced one
        result.update(metrics={}, busy_s=0.0, window_s=0.0,
                      breakdown={"device_ops": [], "idle_gaps": []})
    elif traced:
        untraced = [(s, loc) for s, p, loc in rounds if not p]
        walls = sorted(s for s, _loc in untraced)
        rec["untraced"] = {"seconds": sum(walls), "flops": round_flops(cell) * len(walls),
                           "images": C.images_per_round(cell) * len(walls),
                           "median_round_s": statistics.median(walls) if walls else 0.0,
                           "local_s": sum(loc for _s, loc in untraced)}
        rec["peak_flops"] = peaks.FLOPS[cell.config["compute_dtype"]]
        rec["peak_bytes_per_s"] = peaks.BYTES_PER_S
        result["metrics"] = read_metrics(rec, metrics, cell.root)
        result["busy_s"], result["window_s"] = trace.busy_window_s(rec)
        result["breakdown"] = rec.pop("breakdown")
    else:
        result["metrics"] = {
            "train_img_per_s": {"value": C.images_per_round(cell) * len(rounds) / window_s,
                                "unit": "img/s"},
            "peak_mem_gib": {"value": window_peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}

    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["correct"], result["checks"], result["readings"] = False, {}, {}
    if failed == 0:
        ref = reference_rounds(cell, seed, inputs)
        result["readings"] = compare.readings(prog, ref, inputs["weights"])
        result["correct"], result["checks"] = compare.judge(result["readings"], cell.limits)
    return result


def _traced_round(trainer, rnd: int, device, cell: C.Cell) -> dict:
    """One round under the profiler → the readers' record, its breakdown and
    the round's losses."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace.ROUND):
            rec = trainer.run_round(rnd)
            sync(device)
    ops, notes, host = trace.events_of(prof)
    out = trace.record(ops, notes, host, steps=C.local_steps_per_round(cell))
    out["warp"] = {"images": C.images_per_round(cell) * cell.traffic["per_image"]["views"],
                   "side": cell.config["image_size"]}
    out["breakdown"] = trace.breakdown(out, host)
    print(f"fedbench: traced round {rnd}: {len(out['ops'])} device ops, "
          f"{sum(1 for op in out['ops'] if op[3])} in local passes (placed by {out['how']}), "
          f"{len(host)} host events", flush=True)
    out["losses"] = rec.client_losses
    return out
