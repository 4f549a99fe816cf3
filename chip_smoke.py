"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernel

Phases, each printing its numbers on a line of its own and raising on the
first failure:

1. build:  nvcc compiles every ``fedmlp_tpu_torch/csrc/*.cu`` (one process
   per source, all at once) into ``fedmlp_tpu_torch/_build/``.
2. kernel: each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its median time (CUDA events), the
   plain version's time and its bound.
3. slice:  the port's FedMLP ``Trainer`` at the flagship geometry
   (EfficientNet-B0, 224 px, batch 32, 20 clients, bf16): two stage-1 rounds
   (the second harvests prototypes), one stage-2 round, then evaluation. The
   kernels' launch counts are reset just before and read just after, and
   must match the count the rounds imply.
4. profile (only when asked for): where a stage-1 round's device time goes.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM: HBM rate (NVIDIA data sheet), and the f32 rate outside the
# tensor cores for the warp's elementwise arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# flagship geometry (bench.py::_bench_fedmlp)
K, B, SIZE, N, N_CLASSES = 20, 32, 224, 2560, 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, each timed with
    its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_build() -> None:
    from fedmlp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    print(f"phase build: {len(logs)} sources in {secs:.2f} s")


def phase_kernel(dev) -> dict:
    from fedmlp_tpu_torch.ops import warp

    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    imgs = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    ang, tx, ty, flip = warp.weak_params(B, SIZE, SIZE, g, dev)
    # identities (θ = tx = ty = 0) in the first quarter, flip forced on in
    # the second, random weak-range draws everywhere
    q = B // 4
    ang[:q] = 0.0
    tx[:q] = 0.0
    ty[:q] = 0.0
    flip[q:2 * q] = True
    ang = torch.where(flip, -ang, ang)
    tx = torch.where(flip, -tx, tx)
    params = warp.paeth_shift_params(torch.deg2rad(ang), tx, ty, SIZE,
                                     SIZE).contiguous()
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

    got = warp.fused_warp_normalize(imgs, params, flip, mean, std)
    ref = warp.fused_warp_normalize_ref(imgs, params, flip, mean, std)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    # tolerance: the kernel rounds every product and sum on its own in the
    # plain version's order, so only the normalize division may differ
    tol = 1e-4
    print(f"phase kernel: fused_warp_normalize B={B} S={SIZE} max_abs_err={err:.3e} "
          f"(tol {tol:g})")
    if not math.isfinite(err) or err > tol:
        raise SystemExit(f"fused_warp_normalize disagrees with its plain version: {err}")

    ms = cuda_ms(lambda: warp.fused_warp_normalize(imgs, params, flip, mean, std), 200)
    plain_ms = cuda_ms(lambda: warp.fused_warp_normalize_ref(imgs, params, flip, mean,
                                                             std), 20)
    n_bytes = B * (SIZE * SIZE * 3 + 3 * SIZE * SIZE * 4 + 9 * 4 + 1)
    # per output pixel: 7 lerps of 4 flops, 3 shift evaluations amortized
    # per row, the normalize's subtract and divide
    n_flops = B * 3 * SIZE * SIZE * (7 * 4 + 2)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print(f"phase kernel: fused_warp_normalize ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} share={bound_ms / ms:.3f} "
          f"library_ms=null (no single PyTorch call computes this warp)")
    return {
        "name": "fused_warp_normalize",
        "route": "cuda",
        "source": "fedmlp_tpu_torch/csrc/fused_warp.cu",
        "replaces": "fedmlp_tpu/ops/pallas_warp.py:329",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
    }


def flagship_config(n_clients: int, n_train: int):
    """bench.py::_bench_fedmlp's flagship FedMLP run, two stage-1 rounds."""
    from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig

    return Config(
        algorithm="fedmlp", model="efficient_b0", batch_size=B, base_lr=3e-5,
        n_clients=n_clients, local_ep=1, rounds_warmup=4, eval_every=10**6,
        seed=1037, p_pos=0.0, fedmlp=FedMLPConfig(rounds_stage1=2),
        data=DataConfig(name="synthetic", n_classes=N_CLASSES, image_size=SIZE,
                        synthetic_train_size=n_train, synthetic_test_size=64),
        compute_dtype="bfloat16", output_dir="",
    )


def phase_slice(dev, card: str) -> dict:
    from fedmlp_tpu_torch.ops import warp
    from fedmlp_tpu_torch.train import Trainer

    cfg = flagship_config(K, N)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase slice: setup {time.perf_counter() - t0:.2f} s")
    imgs_per_round = int(tr.fd.valid.sum().item()) * cfg.local_ep

    # expected launches: two weak views per real stage-1 step, one per
    # stage-2 step, one per harvest chunk and client (one sweep in the last
    # stage-1 round, two in a stage-2 round)
    valid = tr.fd.valid.cpu().numpy()
    steps = sum(int(math.ceil(n / B)) for n in valid.sum(1)) * cfg.local_ep
    chunks = K * int(math.ceil(valid.shape[1] / (4 * B)))
    expected = 2 * (2 * steps) + chunks + (steps + 2 * chunks)

    warp.reset_launch_counts()
    losses = []
    for rnd in range(3):
        t1 = time.perf_counter()
        rec = tr.run_round(rnd)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        losses.extend(rec.client_losses)
        print(f"phase slice: round {rnd} (stage {1 if rnd < 2 else 2}) "
              f"{secs:.3f} s {imgs_per_round / secs:.1f} img/s "
              f"mean loss {sum(rec.client_losses) / K:.5f} [{card}]")
    launches = dict(warp.LAUNCH_COUNTS)
    metrics = tr.evaluate()
    print(f"phase slice: global_test {json.dumps(metrics)}")

    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite client losses: {losses}")
    off = [n for n, p in tr.model.named_parameters() if p.device.type != "cuda"]
    if off:
        raise SystemExit(f"parameters off the card: {off[:5]}")
    for key in ("tao", "proto"):
        v = tr.server_state[key]
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise SystemExit(f"non-finite server state {key}")
    n_tagged = int((tr.server_state["tags"] > 0).sum())
    print(f"phase slice: tagged cells {n_tagged}, launches {launches}, "
          f"expected fused_warp_normalize {expected}")
    if launches["fused_warp_normalize"] != expected:
        raise SystemExit(f"fused_warp_normalize launched "
                         f"{launches['fused_warp_normalize']} times, expected {expected}")
    return launches


_KERNEL_KINDS = (
    ("warp", ("fused_warp",)),
    ("conv", ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "cutlass")),
    ("batch_norm", ("batch_norm", "bn_", "batchnorm")),
    ("adam", ("multi_tensor", "adam")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_profile(dev, card: str) -> None:
    """Where a stage-1 round's time goes: torch.profiler over one steady
    stage-1 round of a 2-client trainer with the flagship's per-client
    geometry (B=32, 128 images a client, 224 px, bf16); the flagship round
    repeats this client loop 20 times. Prints the round's wall time, the
    device's busy share, and device time by kernel kind and by kernel."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedmlp_tpu_torch.train import Trainer

    tr = Trainer(flagship_config(2, 2 * 4 * B), device=dev)
    tr.run_round(0)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_round(0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_round(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = defaultdict(float)
    n_kernels = 0
    for e in prof.events():
        # a user annotation (e.g. Optimizer.step) spans kernels that are
        # counted on their own already
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation",
                                                            False):
            by_name[e.name] += e.time_range.elapsed_us()
            n_kernels += 1
    busy_us = sum(by_name.values())
    by_kind = defaultdict(float)
    for name, us in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in _KERNEL_KINDS if any(x in low for x in keys)),
                    "other")
        by_kind[kind] += us
    steps = 2 * 4
    print(f"phase profile: stage-1 round, 2 clients x 4 steps: {plain_s:.3f} s "
          f"unprofiled ({plain_s / steps * 1e3:.1f} ms a step), {wall_s:.3f} s "
          f"profiled, device busy {busy_us / 1e6:.3f} s = "
          f"{busy_us / 1e6 / wall_s:.3f} of the profiled wall, "
          f"{n_kernels / steps:.0f} device ops a step [{card}]")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"phase profile: kind {kind:12s} {us / 1e3:9.2f} ms "
              f"{us / busy_us:.3f} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"phase profile: kernel {us / 1e3:9.2f} ms {us / busy_us:.3f} {name[:110]}")


def main(argv=None) -> int:
    import fedmlp_tpu_torch  # noqa: F401  (fails outside a checkout)

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernel,slice",
                    help="comma list of build,kernel,slice,profile")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if "build" in phases:
        phase_build()
    kernels = []
    if "kernel" in phases:
        kernels.append(phase_kernel(dev))
    if "slice" in phases:
        launches = phase_slice(dev, card)
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if not k["launches"]:
                raise SystemExit(f"{k['name']} never launched on the main path")
    if "profile" in phases:
        phase_profile(dev, card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
