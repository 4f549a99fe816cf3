"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,profile

Phases, each printing its numbers on a line of its own and raising on the
first failure:

1. build:  nvcc compiles every ``fedmlp_tpu_torch/csrc/*.cu`` (one process
   per source, all at once) into ``fedmlp_tpu_torch/_build/``.
2. kernel: each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (the warp, the shear pass and the
   normalize/flip/cutout pass at B=32, 224 px, the warp also at 40° draws
   with two images translated past the plane, and over a hoisted round's
   2560 images and a lockstep or stacked step's 640 in one launch, equal bit
   for bit to launches of 32; the shear
   pass also at a 256-image pre-augment chunk; the normalize/flip/cutout
   pass held to equal bits, also at the evaluation's chunk and at a shape
   that runs one pixel a thread; the two depthwise kernels at the 16
   depthwise layers of EfficientNet-B0, also at B=64, the batch of the
   one-forward stage 1; the masked BCE sum and its gradient
   kernel at [32, 8] and [65536, 8], forward plus backward 2 device
   operations; the fused 1x1-conv + batch-norm kernels at the probe's shapes),
   with its median time (CUDA events), the plain version's time,
   its bound and, where one PyTorch call computes the same function, that
   call's time; beside the warp and the shear pass, the method's floor (a
   one-cycle kernel) and a fill or copy of the same output bytes.
3. slice:  the port's FedMLP ``Trainer`` at the flagship geometry
   (EfficientNet-B0, 224 px, batch 32, 20 clients, bf16): two stage-1 rounds
   (the second harvests prototypes), one stage-2 round, then evaluation. On
   every path the kernels' launch counts are reset just before and read just
   after, and must match the count the rounds imply.
4. slice_dw: the same geometry with ``dw_backend='pallas'``, one stage-1
   round (which harvests) and one stage-2 round: the depthwise backward goes
   through ``dw_dgrad`` and ``dw_wgrad``.
5. cli:    ``fedmlp_tpu_torch.cli.main`` in-process: FedAVG, 4 clients,
   EfficientNet-B0 with ``--dw_backend pallas``, 2 rounds with a checkpoint
   each, then ``--resume`` from round 0's checkpoint; round 1 must repeat.
6. slice_strong: FedAVG+FixMatch at the geometry of the ladder's FixMatch
   rung (tools/ladder.py: EfficientNet-B0, 224 px, batch 32, 20 clients, 8
   classes, p_pos=0, bf16), one round and the evaluation: the weak view
   through ``fused_warp_normalize``, the strong view through nine
   ``hshift_rows`` passes, both loss sums through
   ``bce_with_logits_masked_sum`` and their gradients through
   ``bce_with_logits_masked_grad``, the test transform through
   ``normalize_flip_cutout``. Then CBAFed, 4 clients, warm-up 1, two rounds:
   the second runs the pseudo-label loss with the threshold vector that the
   first set.
7. probe_convbn: the port of tools/probe_fused_conv_bn.py
   (``fedmlp_tpu_torch.tools.probe_fused_conv_bn.main``) at EfficientNet-B0's
   three pointwise shapes in bf16: the unfused matmul chain against
   ``conv1x1_bn_stats`` and ``conv1x1_bn_act_2pass``, interleaved rep by rep.
   The kernel phase holds both kernels against their plain versions at the
   same shapes and at one f32 shape.
8. slice_fednoro: FedNoRo at the ladder's rung-5 geometry (EfficientNet-B0,
   224 px, batch 32, 20 clients, 8 classes, p_pos=0, bf16), warm-up 1, three
   rounds: a FedAvg warm-up, a round that splits the clients with the GMM on
   round 0's losses and aggregates with DaAgg, and a round that trains the
   clean and the noisy clients apart. Only the depth (rounds) is cut.
9. slice_baselines: FedLSR (1 round), RSCFed through ``cli.main`` with
   ``--dw_backend pallas`` (2 rounds with a checkpoint each, then
   ``--resume`` from round 0's: round 1 repeats exactly, and the restored
   per-client teacher differs from the global model), FedIRM (a supervised
   and a relation round: the relation matrix finite and off 0.5), RoFL (2
   rounds: round 0's centroids, then f_G) and ``centralized`` (1 client, 1
   round), each a path of its own at the rung-5 geometry.
10. slice_resnet18: FedMLP on ResNet-18 (the reference's default, spelled
   'Resnet18') at the flagship geometry, the data written to a packed shard
   on disk with ``save_packed_dataset`` and read back with
   ``load_packed_dataset``: two stage-1 rounds (the second harvests), one
   stage-2 round with ``fedmlp.mixup``, and the evaluation, all counted.
11. models_zoo: ResNet-50, SE-ResNet-50, SENet-154, VGG-16, DenseNet-121 and
   ResNet-18 with the cosine head at full width: a float32 forward of one
   model on the card against its copy on the CPU (B=4, 224 px, eval and
   train mode), then one bf16 FedAVG round of 2 clients x 64 images through
   the ``Trainer`` and its evaluation, with its seconds and peak memory.
12. slice_views: the flagship geometry with ``dw_backend='pallas'``,
   ``view_concat='on'`` and ``hoist_augment=1``, two stage-1 rounds and one
   stage-2 round: stage 1 runs one 2B forward a step (B3/B4 at a batch of
   64) and is not hoisted (S·K·B·2 = 5120 view images > 4096); stage 2 makes
   its 2560 views in one warp launch before its first step.
13. slice_preaug: FedAVG+FixMatch at slice_strong's geometry with
   ``pre_augment=256``: the round's views made before it in ten 256-image
   chunks. Then the views of one round made with chunk=256 and chunk=2560
   from one generator state (the weak view equal bit for bit), and
   RandAugmentPC and ``augment_pair`` on the card against the CPU on the
   same draws (B=32, 224 px).
14. slice_lockstep: the flagship with ``batched_global='on'`` (the lockstep
   engine: every step makes each view once for all 640 images and runs the
   frozen global model once a view at batch 640), two stage-1 rounds and
   one stage-2 round beside ``slice``'s; then one stage-1 round at K=4 in
   float32 on 'normonly' views against the per-client loop, client losses
   within 1e-4 relative.
15. slice_stacked: the flagship with ``client_stacking='on'`` (one stacked
   forward and backward a step for all clients; K cut to 10 or 5 only if
   20 do not fit in the card's memory), 2 + 1 rounds with their peak
   memory; then a float32 stacked forward of B0 at 224 px over 2 clients
   against their own forwards, within 1e-3 of the largest logit.
16. slice_knobs: the flagship with each model-side knob, K cut to 1
   client, one counted stage-1 round each (round 0 of two, so no
   harvest), beside ``slice``'s round 0, with the peak memory:
   ``dw_backend`` 'taps', 'dense' and 'reroute', ``remat=1``,
   ``remat_stages='0,1'`` and ``weight_stream=1``, each launching
   ``fused_warp_normalize`` twice a step and nothing else.
   Then the gates: each new backend's float32 B0 forward and backward
   against 'conv'; remat steps of B0 and ResNet-18 against no remat, and a
   ``weight_stream`` step against the step on bf16-rounded parameters, with
   cuDNN deterministic.
17. slice_stream: the flagship with its training images streamed from a
   packed shard on disk (``data.host_stream``, ``stream_window=2``: each
   client's steps in windows of 64 images, the next gathered by the native
   loader while one trains), a stage-1 round that harvests through the
   loader, a stage-2 round and the evaluation, beside ``slice``'s rounds,
   with the shares of the loader's waits and the harvest from the
   program's spans.
   First the gates: at 2 clients, float32, cuDNN deterministic, streamed
   against resident bit for bit on the per-client loop and the lockstep
   engine; the loader's pinned buffers against ``gather_plain``; a traced
   streamed round whose Chrome trace lists CUDA kernels.
18. slice_mesh: the process mesh (``parallel/mesh.py``), two ranks sharing
   the card (gloo on CUDA tensors). First the gates: FedMLP on B0 at
   224 px, K=3 over the two ranks, float32, views drawn, cuDNN
   deterministic, a stage-1 round that harvests and a stage-2 round, equal
   bits to one rank on the same per-client streams; the lockstep engine
   (K=4, 'normonly', dropout-free B0) within 1e-6 relative of one rank's
   client losses, and its gathered global variables beside one rank's; the
   data axis (1 client x 2 data shards, FedAVG on smallcnn) with equal bits
   on both ranks and within 1e-5 relative of the same run on the CPU.
   Gates 4-6 at gate 1's geometry: FixMatch with ``pre_augment=256`` and
   FedMLP with ``hoist_augment=1``, equal bits to one rank; each rank's
   views made before the round equal, bit for bit, the slice of the whole
   round's views made in one process from the same generator state.
   Then ``slice``'s geometry over the two ranks (10 clients each): a stage-1
   round that harvests, a stage-2 round and the evaluation, each rank's
   launches counted and summed into the path's, its round seconds and peak
   memory beside ``slice``'s rounds 1 and 2; and ``slice_mesh_preaug``,
   FixMatch at ``slice_preaug``'s geometry over the two ranks, each making
   its clients' views before the round, one round and the evaluation, the
   ranks' global variables and metrics equal. Last a one-rank NCCL group's
   all-reduce and gather on the card.
18b. cli_torchrun: ``cli``'s arguments plus ``--pre_augment 256`` in two
   processes that ``python -m torch.distributed.run --standalone
   --nproc_per_node 2`` starts on the card (each runs ``cli.main``, which
   starts the group from the environment), beside the same arguments in a
   group that ``parallel.mesh.launch`` starts: exit 0, rank 0's mesh line
   (gloo), one output tree written by rank 0 alone, and the final
   checkpoints' global variables equal bit for bit (cuDNN deterministic).
19. profile, profile_strong, profile_convbn, time_b5b6, time_views,
   time_knobs, time_stream (only
   when asked for): where a stage-1 round's device time goes, for both depthwise
   backends; what the strong view costs a FixMatch step; how the conv-BN
   wrappers' device time divides between their launches; the times and
   device operations of the normalize/flip/cutout and BCE kernels alone
   (this script copied into another commit's checkout times that commit's
   kernels); the rounds of trainers that make their views in the step,
   hoisted, before the round, or concatenated, run in turns; the rounds of
   slice_knobs' trainers at K=4, each beside a knob-free trainer's; the
   flagship's rounds with the table on the card, streamed at once and
   streamed in windows, run in turns.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM: HBM rate (NVIDIA data sheet), the f32 rate outside the tensor
# cores for elementwise arithmetic, and the dense bf16 tensor-core rate for
# products of bf16 operands.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# flagship geometry (bench.py::_bench_fedmlp)
K, B, SIZE, N, N_CLASSES = 20, 32, 224, 2560, 8
# test images of every path: the evaluation sends them as one chunk
N_TEST = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# clock cycles the card spins before a timed call (about 0.5 ms at 1.98 GHz),
# so that the host has queued the call before its first event fires; a call
# through autograd's engine may take the host over 1 ms to queue
HOLD_CYCLES = 1_000_000
AUTOGRAD_HOLD_CYCLES = 8_000_000


def cuda_ms(fn, iters: int, warmup: int = 5, flush=None, hold: bool = True,
            hold_cycles: int = HOLD_CYCLES) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, each timed with
    its own pair of CUDA events. ``flush``, a buffer larger than the 50 MB
    L2, is overwritten before every timed run, so that ``fn`` finds its
    inputs in device memory as a caller in the middle of a backward pass
    does. ``hold``: the card spins before the first event, so the events
    span the device's work alone; without it, an idle card records the
    first event at once and the span also holds the host's time to launch
    ``fn``'s kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        if hold:
            torch.cuda._sleep(hold_cycles)
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


def phase_kernel_warp(dev) -> dict:
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

    # far beyond the weak range: 40° draws, whose source bands outgrow the
    # staged planes, and two images translated past the plane (empty bands)
    ang40, tx40, ty40, flip40 = warp.weak_params(B, SIZE, SIZE, g, dev, degrees=40.0)
    tx40[2] = SIZE + 40.0
    ty40[3] = -(SIZE + 40.0)
    params40 = warp.paeth_shift_params(torch.deg2rad(ang40), tx40, ty40, SIZE,
                                       SIZE).contiguous()

    # tolerance: the kernel rounds every product and sum on its own in the
    # plain version's order, so only the normalize division may differ
    tol, err = 1e-4, 0.0
    for name, (p, f) in {"weak": (params, flip), "40deg+beyond": (params40, flip40)}.items():
        got = warp.fused_warp_normalize(imgs, p, f, mean, std)
        ref = warp.fused_warp_normalize_ref(imgs, p, f, mean, std)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        err = max(err, e)
        print(f"phase kernel: fused_warp_normalize {name} B={B} S={SIZE} "
              f"max_abs_err={e:.3e} (tol {tol:g})")
        if not math.isfinite(e) or e > tol:
            raise SystemExit(f"fused_warp_normalize disagrees with its plain version: "
                             f"{name} {e}")

    ms = cuda_ms(lambda: warp.fused_warp_normalize(imgs, params, flip, mean, std), 200)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    ms_flushed = cuda_ms(lambda: warp.fused_warp_normalize(imgs, params, flip, mean, std),
                         50, 5, flush)
    # yardsticks by the same method: a one-cycle kernel (the method's floor)
    # and writing the output's bytes alone
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(1), 200)
    fill_ms = cuda_ms(lambda: got.zero_(), 200)
    plain_ms = cuda_ms(lambda: warp.fused_warp_normalize_ref(imgs, params, flip, mean,
                                                             std), 20)
    n_bytes = B * (SIZE * SIZE * 3 + 3 * SIZE * SIZE * 4 + 9 * 4 + 1)
    # per output pixel: 7 lerps of 4 flops, 3 shift evaluations amortized
    # per row, the normalize's subtract and divide
    n_flops = B * 3 * SIZE * SIZE * (7 * 4 + 2)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print(f"phase kernel: fused_warp_normalize ms={ms:.4f} (flushed L2 {ms_flushed:.4f}) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} share={bound_ms / ms:.3f} "
          f"library_ms=null (no single PyTorch call computes this warp); "
          f"floor_ms={floor_ms:.4f} (a one-cycle kernel) fill_ms={fill_ms:.4f} "
          f"(zero_ of the f32 output)")
    for n in (N, K * B):
        err = max(err, warp_in_one_launch(dev, flush, n))
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


def warp_in_one_launch(dev, flush, n: int) -> float:
    """The warp over ``n`` images in one launch: N = S·K·B = 2560, a hoisted
    round (the flagship's stage 2 with ``hoist_augment=1``), and K·B = 640,
    one view of a step of the lockstep and stacked engines. Equal bit for bit
    to the same images in launches of 32 and within 1e-4 of the plain
    version; its time from a flushed L2 beside its bound (1926.8 MB at
    N=2560, 481.7 MB at 640, at 3.35 TB/s), the plain version's and a
    ``zero_`` of the output. Returns the error."""
    from fedmlp_tpu_torch.ops import warp

    g = torch.Generator(device=dev)
    g.manual_seed(n)
    imgs = torch.randint(0, 256, (n, SIZE, SIZE, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    ang, tx, ty, flip = warp.weak_params(n, SIZE, SIZE, g, dev)
    params = warp.paeth_shift_params(torch.deg2rad(torch.where(flip, -ang, ang)),
                                     torch.where(flip, -tx, tx), ty, SIZE,
                                     SIZE).contiguous()
    got = warp.fused_warp_normalize(imgs, params, flip, MEAN, STD)
    n_diff = sum(int((warp.fused_warp_normalize(imgs[c:c + B], params[c:c + B],
                                                flip[c:c + B], MEAN, STD)
                      != got[c:c + B]).sum()) for c in range(0, n, B))
    print(f"phase kernel: fused_warp_normalize N={n} in one launch: {n_diff} values "
          f"differ from {n // B} launches of {B} (tol 0)")
    if n_diff:
        raise SystemExit(f"fused_warp_normalize at N={n} differs from launches of {B}")
    ms = cuda_ms(lambda: warp.fused_warp_normalize(imgs, params, flip, MEAN, STD), 10, 2,
                 flush)
    err = float((got - warp.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD))
                .abs().max())
    print(f"phase kernel: fused_warp_normalize N={n} max_abs_err={err:.3e} against the "
          f"plain version (tol 1e-4)")
    if not err <= 1e-4:
        raise SystemExit(f"fused_warp_normalize disagrees with its plain version at N={n}")
    plain_ms = cuda_ms(lambda: warp.fused_warp_normalize_ref(imgs, params, flip, MEAN, STD),
                       3, 1, flush)
    fill_ms = cuda_ms(lambda: got.zero_(), 10, 2, flush)
    n_bytes = n * (SIZE * SIZE * 3 + 3 * SIZE * SIZE * 4 + 9 * 4 + 1)
    bound_ms, bound_by = _bound(n_bytes, n * 3 * SIZE * SIZE * (7 * 4 + 2))
    what = "a hoisted round" if n == N else "a lockstep or stacked step's view"
    print(f"phase kernel: fused_warp_normalize N={n} ({what}) flushed L2 "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
          f"{n_bytes / 1e6:.1f} MB) share={bound_ms / ms:.3f} fill_ms={fill_ms:.4f} "
          f"(zero_ of the f32 output)")
    return err


def _bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(bound ms, what binds) of a function that must move ``n_bytes`` and
    do ``n_flops`` float32 operations outside the tensor cores."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def phase_kernel_hshift(dev) -> dict:
    """``hshift_rows`` at B=32, 3x224x224 on both axes: the weak range
    (Paeth shift vectors of the weak draws), the RandAugment pool's largest
    shifts (shear 0.27 a line: up to 60.2 px; translate 60 px), an integer
    shift (an exact copy) and a shift beyond the plane (zeros). Times are of
    the weak-range pass, every run from a flushed L2."""
    from fedmlp_tpu_torch.ops import warp

    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    x = torch.rand((B, 3, SIZE, SIZE), generator=g, device=dev) * 255.0
    ang, tx, ty, _ = warp.weak_params(B, SIZE, SIZE, g, dev)
    s1, s2, _ = warp.paeth_shift_vectors(torch.deg2rad(ang), tx, ty, SIZE, SIZE)
    line = torch.arange(SIZE, dtype=torch.float32, device=dev)[None]
    sign = torch.where(torch.arange(B, device=dev) % 2 == 0, 1.0, -1.0)[:, None]
    pool = torch.where((torch.arange(B, device=dev) < B // 2)[:, None],
                       sign * 0.27 * line, sign * 60.0 + 0.0 * line)
    cases = {"weak": {3: s1.contiguous(), 2: s2.contiguous()},
             "pool": {3: pool.contiguous(), 2: pool.contiguous()},
             "integer": {a: torch.full((B, SIZE), 7.0, device=dev) for a in (3, 2)},
             "beyond": {a: torch.full((B, SIZE), 300.0, device=dev) for a in (3, 2)}}
    # tolerance: the kernel rounds every product and sum on its own in the
    # plain version's order, so the two are equal to the last bit; 1e-4 on
    # the 0..255 scale allows for a compiler that contracts on one side
    tol, err = 1e-4, 0.0
    for name, by_axis in cases.items():
        for axis, shifts in by_axis.items():
            got = warp.hshift_rows(x, shifts, axis)
            ref = warp.hshift_rows_ref(x, shifts, axis)
            torch.cuda.synchronize()
            e = (got - ref).abs().max().item()
            err = max(err, e)
            print(f"phase kernel: hshift_rows {name} axis={axis} max|s|="
                  f"{shifts.abs().max().item():.1f} max_abs_err={e:.3e} (tol {tol:g})")
            if not math.isfinite(e) or e > tol:
                raise SystemExit(f"hshift_rows disagrees with its plain version: {name}")
            moved = got if axis == 3 else got.transpose(2, 3)
            src = x if axis == 3 else x.transpose(2, 3)
            if name == "integer" and not torch.equal(moved[..., :-7], src[..., 7:]):
                raise SystemExit("hshift_rows: an integer shift is not an exact copy")
            if name == "beyond" and got.any():
                raise SystemExit("hshift_rows: a shift beyond the plane left pixels")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    ms_h = cuda_ms(lambda: warp.hshift_rows(x, cases["weak"][3], 3), 50, 5, flush)
    ms_v = cuda_ms(lambda: warp.hshift_rows(x, cases["weak"][2], 2), 50, 5, flush)
    plain_ms = cuda_ms(lambda: warp.hshift_rows_ref(x, cases["weak"][3], 3), 10, 2, flush)
    # yardstick: a copy of the plane moves the same bytes
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), 50, 5, flush)
    # a warp is (horizontal, vertical, horizontal): the mean launch of the path
    ms = (2.0 * ms_h + ms_v) / 3.0
    # the planes read once and written once, the shifts read; 4 flops a pixel
    bound_ms, bound_by = _bound(2 * x.numel() * 4 + B * SIZE * 4, 4 * x.numel())
    chunk = 256  # a pre_augment=256 chunk
    xc = torch.rand((chunk, 3, SIZE, SIZE), generator=g, device=dev) * 255.0
    sc = ((torch.rand((chunk, SIZE), generator=g, device=dev) * 2.0 - 1.0) * 60.0).contiguous()
    for axis in (3, 2):
        e = (warp.hshift_rows(xc, sc, axis) - warp.hshift_rows_ref(xc, sc, axis)).abs().max()
        err = max(err, float(e))
        print(f"phase kernel: hshift_rows N={chunk} axis={axis} max|s|=60 "
              f"max_abs_err={float(e):.3e} (tol {tol:g})")
        if not float(e) <= tol:
            raise SystemExit(f"hshift_rows disagrees with its plain version at N={chunk}")
    ms_c = {a: cuda_ms(lambda a=a: warp.hshift_rows(xc, sc, a), 20, 3, flush) for a in (3, 2)}
    plain_c = cuda_ms(lambda: warp.hshift_rows_ref(xc, sc, 3), 3, 1, flush)
    yc = torch.empty_like(xc)
    copy_c = cuda_ms(lambda: yc.copy_(xc), 20, 3, flush)
    bound_c, by_c = _bound(2 * xc.numel() * 4 + chunk * SIZE * 4, 4 * xc.numel())
    print(f"phase kernel: hshift_rows N={chunk} 3x{SIZE}x{SIZE} (a pre-augment chunk) "
          f"flushed L2 ms={(2.0 * ms_c[3] + ms_c[2]) / 3.0:.4f} (horizontal {ms_c[3]:.4f}, "
          f"vertical {ms_c[2]:.4f}) plain_ms={plain_c:.4f} bound_ms={bound_c:.4f} "
          f"({by_c}, {(2 * xc.numel() * 4 + chunk * SIZE * 4) / 1e6:.1f} MB a pass) "
          f"share={bound_c / ((2.0 * ms_c[3] + ms_c[2]) / 3.0):.3f} copy_ms={copy_c:.4f}")
    print(f"phase kernel: hshift_rows B={B} 3x{SIZE}x{SIZE} ms={ms:.4f} "
          f"(horizontal {ms_h:.4f}, vertical {ms_v:.4f}) plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} share={bound_ms / ms:.3f} "
          f"library_ms=null (no single PyTorch call computes this shift); "
          f"copy_ms={copy_ms:.4f} (copy_ of the plane, the same bytes)")
    return {
        "name": "hshift_rows", "route": "cuda",
        "source": "fedmlp_tpu_torch/csrc/hshift.cu",
        "replaces": "fedmlp_tpu/ops/pallas_warp.py:109",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _preproc_inputs(dev):
    """B=32, 224 px with mixed flips and, in turn, a 16 px box, a zero box
    (cutout off) and a box cut by the border; the evaluation's chunk of
    ``N_TEST`` images."""
    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    imgs = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    flips = (torch.rand((B,), generator=g, device=dev) < 0.5).to(torch.int32)
    boxes = torch.tensor([[40, 50, 56, 66], [0, 0, 0, 0],
                          [SIZE - 5, SIZE - 9, SIZE + 11, SIZE + 7]],
                         dtype=torch.int32, device=dev).repeat(B, 1)[:B].contiguous()
    chunk = torch.randint(0, 256, (N_TEST, SIZE, SIZE, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    return imgs, flips, boxes, chunk


def measure_preproc(dev) -> dict:
    """Times of ``normalize_flip_cutout`` (ms, every run from a flushed L2)
    at B=32 with flips and boxes and at the evaluation's chunk with neither
    (the call ``eval_batch`` makes), each beside a ``zero_`` of the same
    output bytes, and the plain version's at B=32. Uses only what every
    version of the port has, so that it also times a parent's kernel."""
    from fedmlp_tpu_torch.ops import pallas_ops

    imgs, flips, boxes, chunk = _preproc_inputs(dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    out = torch.empty((B, SIZE, SIZE, 3), dtype=torch.float32, device=dev)
    out_eval = torch.empty((N_TEST, SIZE, SIZE, 3), dtype=torch.float32, device=dev)
    return {
        "ms": cuda_ms(lambda: pallas_ops.normalize_flip_cutout(
            imgs, flips, boxes, MEAN, STD), 50, 5, flush),
        "zero_ms": cuda_ms(lambda: out.zero_(), 50, 5, flush),
        "eval_ms": cuda_ms(lambda: pallas_ops.normalize_flip_cutout(
            chunk, None, None, MEAN, STD), 50, 5, flush),
        "eval_zero_ms": cuda_ms(lambda: out_eval.zero_(), 50, 5, flush),
        "plain_ms": cuda_ms(lambda: pallas_ops.normalize_flip_cutout_ref(
            imgs, flips, boxes, MEAN, STD), 10, 2, flush),
    }


def phase_kernel_preproc(dev) -> dict:
    """``normalize_flip_cutout`` held to equal bits (tolerance 0: every value
    is an entry of the kernel's gray-level table, which holds the plain
    version's own operation for each level) at B=32, 224 px with flips and
    boxes; through ``eval_batch`` at the evaluation's chunk; and at W = 47,
    a shape that runs one pixel a thread, as a view one image into its
    batch. Then its times beside a ``zero_`` of the same output."""
    from fedmlp_tpu_torch.ops import augment, pallas_ops

    imgs, flips, boxes, chunk = _preproc_inputs(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(47)
    odd = torch.randint(0, 256, (4, 33, 47, 3), generator=g, device=dev,
                        dtype=torch.uint8)[1:]
    odd_flips = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    odd_boxes = torch.tensor([[3, 2, 20, 9], [0, 0, 0, 0], [40, 30, 60, 40]],
                             dtype=torch.int32, device=dev)
    cases = {
        f"B={B} {SIZE}px flips={int(flips.sum())} boxes": (imgs, flips, boxes, True),
        f"eval_batch B={N_TEST} {SIZE}px no flips, no boxes": (chunk, None, None, True),
        "B=3 33x47 px, a view one image in (one pixel a thread)":
            (odd, odd_flips, odd_boxes, False),
    }
    for name, (x, f, bx, vec4) in cases.items():
        if f is None:
            got = augment.eval_batch(x, MEAN, STD).permute(0, 2, 3, 1)
        else:
            got = pallas_ops.normalize_flip_cutout(x, f, bx, MEAN, STD)
        ref = pallas_ops.normalize_flip_cutout_ref(x, f, bx, MEAN, STD)
        plan = pallas_ops.normalize_flip_cutout_plan(x, got, MEAN, STD)[0]
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum())
        print(f"phase kernel: normalize_flip_cutout {name}: four pixels a thread {plan}, "
              f"{n_diff} values differ from the plain version (tol 0)")
        if n_diff or got.shape != x.shape[:3] + (3,) or plan != vec4:
            raise SystemExit(f"normalize_flip_cutout disagrees with its plain version: "
                             f"{name}")
    t = measure_preproc(dev)
    # u8 read once, f32 written once, flips and boxes read; 2 flops a value
    bound_ms, bound_by = _bound(imgs.numel() * 5 + B * 20, 2 * imgs.numel())
    eval_bound_ms, _ = _bound(chunk.numel() * 5, 2 * chunk.numel())
    print(f"phase kernel: normalize_flip_cutout B={B} flushed L2 ms={t['ms']:.4f} "
          f"plain_ms={t['plain_ms']:.4f} bound_ms={bound_ms:.5f} "
          f"share={bound_ms / t['ms']:.3f} zero_ms={t['zero_ms']:.4f} (zero_ of the "
          f"same output) library_ms=null (no single PyTorch call flips, fills and "
          f"normalizes); eval chunk B={N_TEST} ms={t['eval_ms']:.4f} "
          f"zero_ms={t['eval_zero_ms']:.4f} bound_ms={eval_bound_ms:.5f} "
          f"share={eval_bound_ms / t['eval_ms']:.3f}")
    return {
        "name": "normalize_flip_cutout", "route": "cuda",
        "source": "fedmlp_tpu_torch/csrc/preproc.cu",
        "replaces": "fedmlp_tpu/ops/pallas_ops.py:66",
        "launches": None, "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def _bce_case(dev, g, n_rows: int):
    x = torch.randn((n_rows, N_CLASSES), generator=g, device=dev) * 4.0
    x[0, 0], x[0, 1], x[-1, -1] = 30.0, -30.0, -30.0
    y = (torch.rand((n_rows, N_CLASSES), generator=g, device=dev) < 0.4).float()
    y[0, 0], y[0, 1] = 0.0, 1.0  # the saturated logits on their costly side
    pw = torch.rand((N_CLASSES,), generator=g, device=dev) * 3.5 + 0.5
    mask = (torch.rand((n_rows, N_CLASSES), generator=g, device=dev) < 0.7).float()
    return x, y, pw, mask


# FixMatch's cotangent of the supervised sum, 1 / (B · n_active) at 5 of 8
# classes: the gradient is checked and timed with g != 1
BCE_COT = 1.0 / (B * 5)


def _device_ops(fn) -> list:
    """Names of the device operations ``fn()`` runs, by the profiler."""
    _, by_name, counts = profiled(fn)
    return [name for name in by_name for _ in range(counts[name])]


def measure_bce(dev, n_rows: int) -> dict:
    """Times (ms) of ``bce_with_logits_masked_sum`` at [n_rows, 8]: the
    forward, the backward (``torch.autograd.grad`` on a kept graph), and
    the two together, each with a hold of ``AUTOGRAD_HOLD_CYCLES`` (device
    time) and without it (the host's launches included), from a flushed L2; beside them the plain
    forward and ``F.binary_cross_entropy_with_logits(weight=mask,
    pos_weight=pw, reduction='sum')`` forward and forward plus backward; and
    the device operations of one forward plus backward. Uses only what every
    version of the port has, so that it also measures a parent's kernels."""
    import torch.nn.functional as F

    from fedmlp_tpu_torch.ops import pallas_ops

    g = torch.Generator(device=dev)
    g.manual_seed(1037 + n_rows)
    x, y, pw, mask = _bce_case(dev, g, n_rows)
    x.requires_grad_(True)
    cot = torch.tensor(BCE_COT, device=dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def fwd():
        return pallas_ops.bce_with_logits_masked_sum(x, y, pw, mask)

    def lib_fwd():
        return F.binary_cross_entropy_with_logits(x, y, weight=mask, pos_weight=pw,
                                                  reduction="sum")

    kept = fwd()
    t = {}
    for hold in (True, False):
        tag = "" if hold else "_launch"
        t["fwd_ms" + tag] = cuda_ms(fwd, 50, 5, flush, hold, AUTOGRAD_HOLD_CYCLES)
        t["bwd_ms" + tag] = cuda_ms(lambda: torch.autograd.grad(
            kept, x, cot, retain_graph=True), 50, 5, flush, hold, AUTOGRAD_HOLD_CYCLES)
        t["fwd_bwd_ms" + tag] = cuda_ms(lambda: torch.autograd.grad(fwd(), x, cot),
                                        50, 5, flush, hold, AUTOGRAD_HOLD_CYCLES)
        t["library_fwd_bwd_ms" + tag] = cuda_ms(lambda: torch.autograd.grad(
            lib_fwd(), x, cot), 50, 5, flush, hold, AUTOGRAD_HOLD_CYCLES)
    t["library_ms"] = cuda_ms(lib_fwd, 50, 5, flush)
    xd = x.detach()
    t["plain_ms"] = cuda_ms(lambda: pallas_ops.bce_with_logits_masked_sum_ref(
        xd, y, pw, mask), 20, 3, flush)
    t["fwd_bwd_ops"] = _device_ops(lambda: torch.autograd.grad(fwd(), x, cot))
    t["library_fwd_bwd_ops"] = _device_ops(lambda: torch.autograd.grad(lib_fwd(), x, cot))
    return t


def phase_kernel_bce(dev) -> list:
    """``bce_with_logits_masked_sum`` at the training shape [32, 8] (logits
    up to +-30) and at [65536, 8], where bytes and not a launch bind: the
    value against the plain version in f32 and in float64, equal bits on a
    repeat; the gradient kernel, with g = 1/(B·5), against
    ``bce_with_logits_masked_grad_ref``; one launch each way, and 2 device
    operations for forward plus backward. Then the times of
    ``measure_bce`` and of the gradient kernel alone."""
    from fedmlp_tpu_torch.ops import pallas_ops

    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    rows = []
    for n_rows in (B, 65536):
        x, y, pw, mask = _bce_case(dev, g, n_rows)
        x.requires_grad_(True)
        cot = torch.tensor(BCE_COT, device=dev)
        pallas_ops.reset_launch_counts()
        got = pallas_ops.bce_with_logits_masked_sum(x, y, pw, mask)
        again = pallas_ops.bce_with_logits_masked_sum(x, y, pw, mask)
        (dx,) = torch.autograd.grad(got, x, cot)
        launches = dict(pallas_ops.LAUNCH_COUNTS)
        xd = x.detach()
        ref = pallas_ops.bce_with_logits_masked_sum_ref(xd, y, pw, mask)
        exact = pallas_ops.bce_with_logits_masked_sum_ref(
            xd.double(), y.double(), pw.double(), mask.double())
        dx_ref = pallas_ops.bce_with_logits_masked_grad_ref(cot, xd, y, pw, mask)
        torch.cuda.synchronize()
        err = abs(got.item() - ref.item())
        err64 = abs(got.item() - exact.item())
        # tolerance: f32 sums of n terms in another order than the plain
        # version's: 1e-5 of the value against the plain version run in
        # float64, twice that against the float32 one (which carries its own
        # rounding)
        tol = 1e-5 * abs(exact.item())
        # the gradient: both round every product in the same order, but the
        # kernel's expf and torch's sigmoid may differ in the last bit of p,
        # which g·pw (or g) scales: 2 ulps of |g|·max(pw, 1)
        gtol = 2.0 * _ulp(cot.abs() * torch.clamp(pw, min=1.0), torch.float32)
        gexcess = ((dx - dx_ref).abs() / gtol).max().item()
        gerr = (dx - dx_ref).abs().max().item()
        print(f"phase kernel: bce_with_logits_masked_sum [{n_rows}, {N_CLASSES}] "
              f"value={got.item():.6f} max_abs_err={err:.3e} (tol {2 * tol:.3e}) "
              f"err_vs_float64={err64:.3e} (tol {tol:.3e}) repeat_equal="
              f"{torch.equal(got, again)}; gradient g={BCE_COT:.6g} max_abs_err="
              f"{gerr:.3e}, {gexcess:.3f} of its tolerance (2 ulps of |g|·max(pw, 1)), "
              f"{int((dx != dx_ref).sum())} of {dx.numel()} differ; launches {launches}")
        if (not math.isfinite(got.item()) or err > 2 * tol or err64 > tol
                or not math.isfinite(gexcess) or gexcess > 1.0):
            raise SystemExit(f"bce_with_logits_masked_sum disagrees at {n_rows} rows")
        if not torch.equal(got, again):
            raise SystemExit("bce_with_logits_masked_sum gave different bits on a repeat")
        if launches != {"normalize_flip_cutout": 0, "bce_with_logits_masked_sum": 2,
                        "bce_with_logits_masked_grad": 1}:
            raise SystemExit(f"bce_with_logits_masked_sum: launches {launches}")
        t = measure_bce(dev, n_rows)
        grad_ms = cuda_ms(lambda: pallas_ops.bce_with_logits_masked_grad(
            cot, xd, y, pw, mask), 50, 5, flush)
        grad_plain_ms = cuda_ms(lambda: pallas_ops.bce_with_logits_masked_grad_ref(
            cot, xd, y, pw, mask), 20, 3, flush)
        n_ops = len(t["fwd_bwd_ops"])
        print(f"phase kernel: bce_with_logits_masked_sum [{n_rows}, {N_CLASSES}] device "
              f"ops of forward + backward: {n_ops} {sorted(set(t['fwd_bwd_ops']))}; "
              f"library forward + backward: {len(t['library_fwd_bwd_ops'])}")
        if n_rows == B and n_ops != 2:
            raise SystemExit(f"bce_with_logits_masked_sum forward + backward ran {n_ops} "
                             f"device operations, not 2")
        # three [B, C] operands and pos_weight read once, a scalar written;
        # about 25 flops an element (two log-sigmoids, the blend, the mask)
        bound_ms, bound_by = _bound(3 * x.numel() * 4 + pw.numel() * 4 + 4,
                                    25 * x.numel())
        # the gradient: x, y and the mask read, dx written, pos_weight and g
        # read; about 10 flops an element (exp, the reciprocal, the blend)
        grad_bound_ms, grad_bound_by = _bound(4 * x.numel() * 4 + pw.numel() * 4 + 4,
                                              10 * x.numel())
        print(f"phase kernel: bce_with_logits_masked_sum [{n_rows}, {N_CLASSES}] "
              f"flushed L2, device ms (with the host's launches): forward "
              f"{t['fwd_ms']:.4f} ({t['fwd_ms_launch']:.4f}), backward {t['bwd_ms']:.4f} "
              f"({t['bwd_ms_launch']:.4f}), forward + backward {t['fwd_bwd_ms']:.4f} "
              f"({t['fwd_bwd_ms_launch']:.4f}); library forward + backward "
              f"{t['library_fwd_bwd_ms']:.4f} ({t['library_fwd_bwd_ms_launch']:.4f}); "
              f"forward plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"bound_ms={bound_ms:.7f} share={bound_ms / t['fwd_ms']:.5f}; gradient "
              f"kernel ms={grad_ms:.4f} plain_ms={grad_plain_ms:.4f} "
              f"bound_ms={grad_bound_ms:.7f} share={grad_bound_ms / grad_ms:.5f} "
              f"(library: F.binary_cross_entropy_with_logits, reduction='sum')")
        if n_rows == B:  # the training shape is the one the main path runs
            common = {"route": "cuda", "source": "fedmlp_tpu_torch/csrc/bce.cu",
                      "launches": None}
            rows = [
                {**common, "name": "bce_with_logits_masked_sum",
                 "replaces": "fedmlp_tpu/ops/pallas_ops.py:149", "max_abs_err": err,
                 "ms": t["fwd_ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": t["library_ms"]},
                # B6's backward: no one PyTorch call computes this gradient
                {**common, "name": "bce_with_logits_masked_grad",
                 "replaces": "fedmlp_tpu/ops/pallas_ops.py:163", "max_abs_err": gerr,
                 "ms": grad_ms, "plain_ms": grad_plain_ms, "bound_ms": grad_bound_ms,
                 "bound_by": grad_bound_by, "library_ms": None},
            ]
    return rows


def phase_time_b5b6(dev, card: str) -> None:
    """``measure_preproc`` and ``measure_bce`` alone, with no check that a
    parent's kernels would fail: copied into a checkout of another commit
    and run there, this times that commit's two kernels on the same card."""
    import fedmlp_tpu_torch

    where = fedmlp_tpu_torch.__file__
    t = measure_preproc(dev)
    print(f"phase time_b5b6 [{where}]: normalize_flip_cutout "
          + " ".join(f"{k}={v:.4f}" for k, v in t.items()) + f" [{card}]")
    for n_rows in (B, 65536):
        t = measure_bce(dev, n_rows)
        ops = t.pop("fwd_bwd_ops")
        lib_ops = t.pop("library_fwd_bwd_ops")
        print(f"phase time_b5b6 [{where}]: bce [{n_rows}, {N_CLASSES}] "
              + " ".join(f"{k}={v:.4f}" for k, v in t.items())
              + f" fwd_bwd_ops={len(ops)} library_fwd_bwd_ops={len(lib_ops)} [{card}]")
        if n_rows == B:
            print(f"phase time_b5b6 [{where}]: forward + backward device ops: {ops}")


def _ulp(v, dtype):
    """One ulp of ``dtype`` at |v| (an f32 tensor)."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=1e-30))) - bits)


def _reordered_sum_bound(x, w):
    """Per element of x·w [M, Co]: 2·Ci·2⁻²⁴·Σ_k|x_k·w_k|, how far an f32
    sum of the Ci products in another order than the plain version's may
    lie from it. Each of the Ci − 1 additions rounds (the tensor cores may
    truncate) by at most 2⁻²³ of a partial sum, itself at most Σ_k|x_k·w_k|.
    The TPU's MXU sums in its own order too; the CPU tests hold the plain
    version to JAX within the same bound."""
    from fedmlp_tpu_torch.ops import fused_conv_bn as CB

    return 2.0 * x.shape[1] * 2.0 ** -24 * CB._product_ref(x.abs(), w.abs())


def _y_excess_ulps(y, yr, x, w, dtype):
    """|y − yr| in ulps of ``dtype`` at yr, beyond the reordered-sum bound
    for bf16 (the tensor-core route); f32 keeps the plain version's order,
    so its bound is 0. The kernel's y passes with at most one ulp, on at
    most 1% of the elements."""
    err = (y.float() - yr.float()).abs()
    if dtype == torch.bfloat16:
        err = (err - _reordered_sum_bound(x, w)).clamp(min=0.0)
    return err / _ulp(yr.float(), dtype)


def _conv_bn_case(dev, M, Ci, Co, dtype, act: str = "swish") -> dict:
    """Both conv-BN kernels against their plain versions on one shape, each
    called twice; the tolerances are stated in ``phase_kernel_conv_bn``.
    Returns the errors and whether the checks held."""
    from fedmlp_tpu_torch.ops import fused_conv_bn as CB

    g = torch.Generator(device=dev)
    g.manual_seed(M + Ci)
    x = torch.randn((M, Ci), generator=g, device=dev).to(dtype)
    w = torch.randn((Ci, Co), generator=g, device=dev).to(dtype)
    scale = torch.rand((Co,), generator=g, device=dev) + 0.5
    bias = torch.randn((Co,), generator=g, device=dev)
    y, s, ss = CB.conv1x1_bn_stats(x, w)
    y2, s2, ss2 = CB.conv1x1_bn_stats(x, w)
    out, mean, var = CB.conv1x1_bn_act_2pass(x, w, scale, bias, act=act)
    out2, mean2, var2 = CB.conv1x1_bn_act_2pass(x, w, scale, bias, act=act)
    yr, sr, ssr = CB.conv1x1_bn_stats_ref(x, w)
    outr, meanr, varr = CB.conv1x1_bn_act_2pass_ref(x, w, scale, bias, act=act)
    torch.cuda.synchronize()
    yf = CB._product_ref(x, w)
    abs_sum, sq_sum = float(yf.abs().sum()), float((yf * yf).sum())
    y_err = (y.float() - yr.float()).abs()
    y_ulps = _y_excess_ulps(y, yr, x, w, dtype)
    _, _, mul, add = CB.fold_batch_norm(s, ss, M, scale, bias, 1e-3)
    _, _, mulr, addr = CB.fold_batch_norm(sr, ssr, M, scale, bias, 1e-3)
    # z = y·mul + add differs by what the two sets of statistics make of it
    # and by one f32 rounding of the product y·mul and one of the sum on each
    # side (the product's may be far above z's where the sum cancels), and
    # in bf16 by the reordered sum's bound on y times |mul|; out moves by at
    # most the activation's slope (swish: under 1.1) times that
    ym = yf * mulr
    dz = (yf.abs() * (mul - mulr).abs() + (add - addr).abs()
          + _ulp(ym, torch.float32) + _ulp(ym + addr, torch.float32))
    if dtype == torch.bfloat16:
        dz = dz + _reordered_sum_bound(x, w) * mulr.abs()
    spread = (1.1 if act == "swish" else 1.0) * dz
    out_err = (out.float() - outr.float()).abs()
    # in ulps of the larger of the two values (the plain version's may be 0)
    out_ulps = ((out_err - spread).clamp(min=0.0)
                / _ulp(torch.maximum(out.float().abs(), outr.float().abs()), dtype))
    n_ulp = 1 if dtype == torch.bfloat16 else 4
    stats_rel = max(float((s - sr).abs().max()) / abs_sum,
                    float((ss - ssr).abs().max()) / sq_sum,
                    float((mean - meanr).abs().max()) * M / abs_sum,
                    float((var - varr).abs().max()) * M / (2.0 * sq_sum))
    repeat = all(torch.equal(a, b) for a, b in ((y, y2), (s, s2), (ss, ss2), (out, out2),
                                                 (mean, mean2), (var, var2)))
    res = {
        "y_err": float(y_err.max()), "out_err": float(out_err.max()),
        "y_ulps": float(y_ulps.max()), "out_ulps": float(out_ulps.max()),
        "y_share": float((y_ulps > 0).float().mean()),
        "out_share": float((out_ulps > 0).float().mean()),
        "stats_rel": stats_rel, "repeat": repeat,
        "finite": bool(torch.isfinite(out.float()).all() and torch.isfinite(y.float()).all()),
    }
    res["ok"] = (res["finite"] and repeat and res["y_ulps"] <= 1.0 and res["out_ulps"] <= n_ulp
                 and res["y_share"] <= 0.01 and res["out_share"] <= 0.01 and stats_rel <= 1e-5
                 and y.dtype == out.dtype == dtype)
    return res


def phase_kernel_conv_bn(dev) -> list:
    """``conv1x1_bn_stats`` and ``conv1x1_bn_act_2pass`` against their plain
    versions at the probe's three shapes (EfficientNet-B0's pointwise
    expansions at B=32, 224 px) in bf16 and at the third in f32. Tolerances:
    y within one ulp of its type beyond the reordered-sum bound (bf16, where
    the tensor cores sum in their own order: ``_reordered_sum_bound``) or of
    the plain version's y (f32, summed in the plain version's order, so it
    should be equal), at most 1% of the elements off; sum and sum of
    squares within 1e-5 relative to Σ|y| and Σy², mean and var the same
    over M; out within one bf16 ulp (four f32 ulps: the sigmoid's exp and
    the last rounding) of the larger of the two values, beyond 1.1 (the
    swish's largest slope) times |y|·Δmul + Δadd + one f32 ulp of y·mul and
    one of z, what the two sets of statistics and their roundings make of
    z = y·mul + add, plus in bf16 the reordered-sum bound times |mul|, at
    most 1% of the elements off; equal bits on a repeat. Times are sums
    over the three bf16 shapes, every run from a flushed L2; the library
    column is the unfused chain of the probe (``torch.matmul``, then the
    statistics, or the statistics, batch norm and swish). Per shape, two
    yardsticks by the same method: ``torch.matmul(x, w)`` alone (the
    tensor-core product that writes y) and a ``copy_`` of y's bytes."""
    from fedmlp_tpu_torch.ops import fused_conv_bn as CB
    from fedmlp_tpu_torch.tools.probe_fused_conv_bn import SHAPES, candidates

    cases = [(M, Ci, Co, torch.bfloat16) for M, Ci, Co in SHAPES]
    cases.append(SHAPES[2] + (torch.float32,))
    stats = {n: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bytes_ms": 0.0, "flops_ms": 0.0}
             for n in ("conv1x1_bn_stats", "conv1x1_bn_act_2pass")}
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for M, Ci, Co, dtype in cases:
        res = _conv_bn_case(dev, M, Ci, Co, dtype)
        tname = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"phase kernel: conv1x1_bn [{M}, {Ci}]x[{Ci}, {Co}] {tname} y max_abs_err="
              f"{res['y_err']:.3e} ({res['y_ulps']:.0f} ulp, share {res['y_share']:.2e}) "
              f"out max_abs_err={res['out_err']:.3e} ({res['out_ulps']:.2f} ulp beyond the "
              f"statistics' spread, share {res['out_share']:.2e}) stats_rel="
              f"{res['stats_rel']:.2e} (tol 1e-05) repeat_equal={res['repeat']}")
        if not res["ok"]:
            raise SystemExit(f"conv1x1_bn kernels disagree at {(M, Ci, Co, tname)}: {res}")
        stats["conv1x1_bn_stats"]["err"] = max(stats["conv1x1_bn_stats"]["err"], res["y_err"])
        stats["conv1x1_bn_act_2pass"]["err"] = max(stats["conv1x1_bn_act_2pass"]["err"],
                                                   res["out_err"])
        g = torch.Generator(device=dev)
        g.manual_seed(M)
        x = torch.randn((M, Ci), generator=g, device=dev).to(dtype)
        w = torch.randn((Ci, Co), generator=g, device=dev).to(dtype)
        scale = torch.rand((Co,), generator=g, device=dev) + 0.5
        bias = torch.randn((Co,), generator=g, device=dev)
        unfused, fused, unfusedfull, fused2p = candidates(x, w, scale, bias)
        ybuf = torch.empty((M, Co), dtype=dtype, device=dev)
        ysrc = torch.ones((M, Co), dtype=dtype, device=dev)
        matmul_ms = cuda_ms(lambda: torch.matmul(x, w), 20, 3, flush)
        copy_ms = cuda_ms(lambda: ybuf.copy_(ysrc), 20, 3, flush)
        e = x.element_size()
        # x and w read once, y (or out) written once, the [Co] vectors; the
        # product's 2*M*Ci*Co operations at the bf16 tensor-core rate (f32:
        # the CUDA cores' rate)
        n_bytes = (M * Ci + Ci * Co + M * Co) * e + 4 * Co * 4
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        flops_ms = 2.0 * M * Ci * Co / rate * 1e3
        for kname, fn, plain, library in (
                ("conv1x1_bn_stats", fused, lambda: CB.conv1x1_bn_stats_ref(x, w), unfused),
                ("conv1x1_bn_act_2pass", fused2p,
                 lambda: CB.conv1x1_bn_act_2pass_ref(x, w, scale, bias), unfusedfull)):
            st = stats[kname]
            ms = cuda_ms(fn, 20, 3, flush)
            plain_ms = cuda_ms(plain, 3, 1, flush)
            library_ms = cuda_ms(library, 20, 3, flush)
            bound_ms = max(n_bytes / HBM_BYTES_PER_S * 1e3, flops_ms)
            print(f"phase kernel: {kname} [{M}, {Ci}]x[{Ci}, {Co}] {tname} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.5f} ({n_bytes / 1e6:.2f} MB) share={bound_ms / ms:.3f} "
                  f"matmul_ms={matmul_ms:.4f} copy_ms={copy_ms:.4f}")
            if dtype != torch.bfloat16:
                continue  # the sums are over the bf16 shapes
            st["ms"] += ms
            st["plain_ms"] += plain_ms
            st["library_ms"] += library_ms
            st["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
            st["flops_ms"] += flops_ms
    out = []
    for kname, line in (("conv1x1_bn_stats", 125), ("conv1x1_bn_act_2pass", 66)):
        st = stats[kname]
        bound_ms = max(st["bytes_ms"], st["flops_ms"])
        print(f"phase kernel: {kname} 3 probe shapes bf16: ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
              f"bound_ms={bound_ms:.4f} share={bound_ms / st['ms']:.3f} "
              f"(library: the unfused torch.matmul chain)")
        out.append({
            "name": kname, "route": "cuda", "source": "fedmlp_tpu_torch/csrc/conv_bn.cu",
            "replaces": f"tools/fused_conv_bn.py:{line}", "launches": None,
            "max_abs_err": st["err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if st["bytes_ms"] >= st["flops_ms"] else "operations",
            "library_ms": st["library_ms"],
        })
    return out


def dw_layer_calls(dev) -> list:
    """(name, C, H, W, k, stride, pads) of every depthwise layer, as one
    B=32, 224 px forward of ``efficientnet_b0(dw_backend='pallas')`` calls
    it: the 16 shapes the flagship's backward hands the two kernels."""
    from fedmlp_tpu_torch.models import build_model, init_model
    from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas

    model = init_model(build_model("efficient_b0", N_CLASSES, dw_backend="pallas"),
                       1037).to(dev).eval()
    calls = []
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, args, name=name: calls.append(
                (name, mod.features, args[0].shape[2], args[0].shape[3],
                 mod.kernel, mod.stride, args[1])))
        for name, m in model.named_modules() if isinstance(m, DepthwisePallas)]
    with torch.no_grad():
        model(torch.zeros((B, 3, SIZE, SIZE), device=dev))
    for h in hooks:
        h.remove()
    if len(calls) != 16:
        raise SystemExit(f"expected 16 depthwise layers, saw {len(calls)}")
    return calls


def _dw_case(dev, g, call, dtype, batch: int = B):
    """Random operands of one layer's backward at ``batch`` images: x, the
    strided cotangent, the filter, and the padded input that the library's
    convolution backward takes."""
    _, C, H, W, k, stride, pads = call
    (pt, pb), (pl, pr) = pads
    Ho, Wo = (H + pt + pb - k) // stride + 1, (W + pl + pr - k) // stride + 1
    x = torch.randn((batch, C, H, W), generator=g, device=dev).to(dtype)
    dy = torch.randn((batch, C, Ho, Wo), generator=g, device=dev).to(dtype)
    w = (torch.randn((C, 1, k, k), generator=g, device=dev) * 0.2).to(dtype)
    return {"x": x, "dy": dy, "w": w, "k": k, "stride": stride, "pads": pads,
            "xp": torch.nn.functional.pad(x, (pl, pr, pt, pb))}


def _library_backward(case, mask):
    """PyTorch's own convolution backward for the layer (input gradient or
    weight gradient alone): the yardstick, called by nothing in the port."""
    C = case["x"].shape[1]
    s = case["stride"]
    return torch.ops.aten.convolution_backward(
        case["dy"], case["xp"], case["w"], None, [s, s], [0, 0], [1, 1], False,
        [0, 0], C, mask)


def _dw_check(call, dtype, dx, dx_ref, dw, dw2, dw_ref) -> tuple[float, float]:
    """(dx error, dw error) of one layer, or SystemExit.

    dx tolerance. f32: the kernel accumulates the taps with FMAs, the plain
    version rounds each product and sum, so they differ by a few f32 ulps of
    sums of magnitude ~1: 1e-5. bf16: both round an f32 sum that differs by
    those ulps to bf16, so a value on a rounding boundary may land one bf16
    ulp apart: 2^-7 relative. dw tolerance: f32 sums of up to 401,408
    products (B*Ho*Wo) in another order than the plain version's: 1e-4 of
    the largest |dw|, in both types (bf16 inputs are read exactly, the
    accumulation is f32 either way); a repeat gives the same bits."""
    dx_err = (dx.float() - dx_ref.float()).abs()
    if dtype == torch.float32:
        dx_bad = float(dx_err.max()) > 1e-5
    else:
        dx_bad = bool((dx_err > dx_ref.float().abs() * 2.0 ** -7 + 1e-6).any())
    dw_err = float((dw - dw_ref).abs().max())
    dw_tol = 1e-4 * float(dw_ref.abs().max())
    name, C, H, W, k, stride, _ = call
    tname = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"phase kernel: {name} B={dx.shape[0]} C={C} {H}x{W} k={k} s={stride} {tname} "
          f"dx max_abs_err={float(dx_err.max()):.3e} "
          f"dw max_abs_err={dw_err:.3e} (tol {dw_tol:.3e}) "
          f"repeat_equal={torch.equal(dw, dw2)}")
    if dx_bad or not math.isfinite(float(dx_err.max())):
        raise SystemExit(f"dw_dgrad disagrees with its plain version at {call}")
    if not dw_err <= dw_tol:
        raise SystemExit(f"dw_wgrad disagrees with its plain version at {call}")
    if not torch.equal(dw, dw2):
        raise SystemExit(f"dw_wgrad gave different bits on a repeat at {call}")
    if dw.dtype != torch.float32 or dx.dtype != dtype or dx.shape != dx_ref.shape:
        raise SystemExit(f"wrong result types or shape {dx.dtype}, {dw.dtype}, "
                         f"{tuple(dx.shape)}")
    return float(dx_err.max()), dw_err


def phase_kernel_dw(dev) -> list:
    """``dw_dgrad`` and ``dw_wgrad`` against their plain versions at the 16
    depthwise layers of EfficientNet-B0 (B=32, 224 px), on the strided
    cotangent: every layer in bf16, the two largest also in f32. Times are
    of the bf16 layers, every run starting from a flushed L2; a line a layer
    and the sums over the 16. ``launch_ms``: the same calls timed without
    the hold, the host's launch time included (the method of the earlier
    kernels' rows, for comparison with them)."""
    from fedmlp_tpu_torch.ops import dw_pallas as dwp

    calls = dw_layer_calls(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    largest = sorted(range(16), key=lambda i: -calls[i][1] * calls[i][2] * calls[i][3])[:2]
    names = ("dw_dgrad", "dw_wgrad")
    stats = {n: {"err": 0.0, "ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0,
                 "library_ms": 0.0, "bytes_ms": 0.0, "flops_ms": 0.0} for n in names}
    for i, call in enumerate(calls):
        _, C, H, W, k, stride, pads = call
        for dtype in [torch.bfloat16] + ([torch.float32] if i in largest else []):
            case = _dw_case(dev, g, call, dtype)
            x, dy, w = case["x"], case["dy"], case["w"]
            fns = {"dw_dgrad": lambda: dwp.dw_dgrad(dy, w, stride, pads, (H, W)),
                   "dw_wgrad": lambda: dwp.dw_wgrad(x, dy, k, stride, pads)}
            refs = {"dw_dgrad": lambda: dwp.dw_dgrad_ref(dy, w, stride, pads, (H, W)),
                    "dw_wgrad": lambda: dwp.dw_wgrad_ref(x, dy, k, stride, pads)}
            dx, dw, dw2 = fns["dw_dgrad"](), fns["dw_wgrad"](), fns["dw_wgrad"]()
            dx_ref, dw_ref = refs["dw_dgrad"](), refs["dw_wgrad"]()
            torch.cuda.synchronize()
            errs = _dw_check(call, dtype, dx, dx_ref, dw, dw2, dw_ref)
            for n, e in zip(names, errs):
                stats[n]["err"] = max(stats[n]["err"], e)
            if dtype != torch.bfloat16:
                continue
            # the bytes the inputs need: x (read, or dx written) at input
            # resolution, dy read at output resolution, the filter read or dw
            # written in f32; 2*k*k flops a cotangent element (each meets k*k
            # taps)
            planes = (x.numel() + dy.numel()) * x.element_size()
            small = {"dw_dgrad": w.numel() * w.element_size(), "dw_wgrad": dw.numel() * 4}
            flops = 2 * k * k * dy.numel()
            line = []
            for n, mask in (("dw_dgrad", [True, False, False]),
                            ("dw_wgrad", [False, True, False])):
                st = stats[n]
                ms = cuda_ms(fns[n], 10, 2, flush)
                launch_ms = cuda_ms(fns[n], 10, 2, flush, hold=False)
                plain_ms = cuda_ms(refs[n], 3, 1, flush)
                library_ms = cuda_ms(lambda: _library_backward(case, mask), 10, 2, flush)
                bytes_ms = (planes + small[n]) / HBM_BYTES_PER_S * 1e3
                flops_ms = flops / F32_FLOP_PER_S * 1e3
                bound = max(bytes_ms, flops_ms)
                st["ms"] += ms
                st["launch_ms"] += launch_ms
                st["plain_ms"] += plain_ms
                st["library_ms"] += library_ms
                st["bytes_ms"] += bytes_ms
                st["flops_ms"] += flops_ms
                line.append(f"{n} ms={ms:.4f} launch_ms={launch_ms:.4f} "
                            f"library_ms={library_ms:.4f} "
                            f"bound_ms={bound:.4f} share={bound / ms:.3f}")
            print(f"phase kernel: layer {i + 1:2d} C={C} {H}x{W} k={k} s={stride} bf16 "
                  + " | ".join(line))
    at_2b = dw_at_2b(dev, calls, g, flush)
    out = []
    for kname, line in (("dw_dgrad", 112), ("dw_wgrad", 144)):
        st = stats[kname]
        st["err"] = max(st["err"], at_2b[kname])
        bound_ms = max(st["bytes_ms"], st["flops_ms"])
        print(f"phase kernel: {kname} 16 layers bf16 B={B}: ms={st['ms']:.4f} "
              f"launch_ms={st['launch_ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"library_ms={st['library_ms']:.4f} "
              f"bound_ms={bound_ms:.4f} share={bound_ms / st['ms']:.3f} "
              f"(library: aten.convolution_backward, one output)")
        out.append({
            "name": kname,
            "route": "cuda",
            "source": "fedmlp_tpu_torch/csrc/dw_conv.cu",
            "replaces": f"fedmlp_tpu/ops/dw_pallas.py:{line}",
            "launches": None,
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if st["bytes_ms"] >= st["flops_ms"] else "operations",
            "library_ms": st["library_ms"],
        })
    return out


def dw_at_2b(dev, calls, g, flush) -> dict:
    """Both depthwise kernels at the 16 B0 layers at B=64 in bf16, the batch
    of FedMLP's one-forward stage 1 (``view_concat='on'``), against their
    plain versions (``_dw_check``'s tolerances); the sums over the layers of
    their times from a flushed L2, the library's and the bounds. Returns
    each kernel's largest error."""
    from fedmlp_tpu_torch.ops import dw_pallas as dwp

    names = ("dw_dgrad", "dw_wgrad")
    st = {n: {"err": 0.0, "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0} for n in names}
    for call in calls:
        _, C, H, W, k, stride, pads = call
        case = _dw_case(dev, g, call, torch.bfloat16, batch=2 * B)
        x, dy, w = case["x"], case["dy"], case["w"]
        fns = {"dw_dgrad": lambda: dwp.dw_dgrad(dy, w, stride, pads, (H, W)),
               "dw_wgrad": lambda: dwp.dw_wgrad(x, dy, k, stride, pads)}
        dx, dw, dw2 = fns["dw_dgrad"](), fns["dw_wgrad"](), fns["dw_wgrad"]()
        errs = _dw_check(call, torch.bfloat16, dx, dwp.dw_dgrad_ref(dy, w, stride, pads, (H, W)),
                         dw, dw2, dwp.dw_wgrad_ref(x, dy, k, stride, pads))
        planes = (x.numel() + dy.numel()) * x.element_size()
        small = {"dw_dgrad": w.numel() * w.element_size(), "dw_wgrad": dw.numel() * 4}
        for n, e, mask in zip(names, errs, ([True, False, False], [False, True, False])):
            st[n]["err"] = max(st[n]["err"], e)
            st[n]["ms"] += cuda_ms(fns[n], 10, 2, flush)
            st[n]["library_ms"] += cuda_ms(lambda: _library_backward(case, mask), 10, 2, flush)
            st[n]["bound_ms"] += _bound(planes + small[n], 2 * k * k * dy.numel())[0]
    for n in names:
        print(f"phase kernel: {n} 16 layers bf16 B={2 * B} (view_concat's 2B): "
              f"ms={st[n]['ms']:.4f} library_ms={st[n]['library_ms']:.4f} "
              f"bound_ms={st[n]['bound_ms']:.4f} share={st[n]['bound_ms'] / st[n]['ms']:.3f}")
    return {n: st[n]["err"] for n in names}


def flagship_config(n_clients: int, n_train: int, rounds_stage1: int = 2,
                    dw_backend: str = "", model: str = "efficient_b0", mixup: int = 0,
                    compute_dtype: str = "bfloat16", augment_backend: str = "auto",
                    **kw):
    """bench.py::_bench_fedmlp's flagship FedMLP run (``kw``: engine knobs)."""
    from fedmlp_tpu_torch.config import Config, DataConfig, FedMLPConfig

    return Config(
        algorithm="fedmlp", model=model, batch_size=B, base_lr=3e-5,
        n_clients=n_clients, local_ep=1, rounds_warmup=4, eval_every=10**6,
        seed=1037, p_pos=0.0, fedmlp=FedMLPConfig(rounds_stage1=rounds_stage1, mixup=mixup),
        data=DataConfig(name="synthetic", n_classes=N_CLASSES, image_size=SIZE,
                        synthetic_train_size=n_train, synthetic_test_size=N_TEST,
                        augment_backend=augment_backend),
        compute_dtype=compute_dtype, dw_backend=dw_backend, output_dir="", **kw,
    )


def plan_steps(tr) -> int:
    """S, the steps of ``tr``'s batch plans (the largest client's)."""
    return tr.cfg.local_ep * int(math.ceil(int(tr.fd.valid.sum(1).max()) / B))


def views_positions(tr) -> int:
    """S·K·B of ``tr``'s rounds: every plan position, padding included."""
    return plan_steps(tr) * tr.n_clients * B


def hoisted(tr, n_views: int) -> bool:
    """Whether ``tr``'s rounds of ``n_views`` views a step make them all
    before the first step (``hoist_augment``, at most
    ``HOIST_MAX_VIEWS`` view images a round; the lockstep engine never)."""
    from fedmlp_tpu_torch.parallel.fl_runtime import HOIST_MAX_VIEWS

    return (bool(tr.cfg.hoist_augment) and tr.engine != "lockstep"
            and views_positions(tr) * n_views <= HOIST_MAX_VIEWS)


# seconds and peak memory (GiB) of each round of each path run so far, by path
ROUND_SECONDS = {}
PEAK_GIB = {}


def reset_launch_counts() -> None:
    from fedmlp_tpu_torch.ops import dw_pallas, fused_conv_bn, pallas_ops, warp

    for mod in (warp, dw_pallas, pallas_ops, fused_conv_bn):
        mod.reset_launch_counts()


def read_launch_counts() -> dict:
    from fedmlp_tpu_torch.ops import dw_pallas, fused_conv_bn, pallas_ops, warp

    return {**warp.LAUNCH_COUNTS, **dw_pallas.LAUNCH_COUNTS, **pallas_ops.LAUNCH_COUNTS,
            **fused_conv_bn.LAUNCH_COUNTS}


def check_launches(path: str, launches: dict, expected: dict) -> None:
    """``expected`` names the kernels the path launches; every other kernel
    must not have been launched at all."""
    expected = {**dict.fromkeys(launches, 0), **expected}
    print(f"phase {path}: launches {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"{path}: kernels launched {launches}, expected {expected}")


def run_flagship(path: str, dev, card: str, cfg, stage1_rounds: int,
                 n_rounds: int, datasets=(None, None),
                 count_eval: bool = False, on_trainer=None) -> dict:
    """Drive ``n_rounds`` rounds of the FedMLP ``Trainer`` at ``cfg`` (on
    ``datasets`` (train, test) where given), with the launch counts set to 0
    just before and read just after (after the final evaluation with
    ``count_eval``); check the outputs and that the counts equal what the
    rounds imply. ``on_trainer(tr)`` sees the trainer before the counted
    span. Returns the launches; each round's seconds go to
    ``ROUND_SECONDS[path]``."""
    from fedmlp_tpu_torch.models import feature_dim_of
    from fedmlp_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    tr = Trainer(cfg, train_ds=datasets[0], test_ds=datasets[1], device=dev)
    torch.cuda.synchronize()
    print(f"phase {path}: setup {time.perf_counter() - t0:.2f} s")
    n_clients = tr.n_clients
    imgs_per_round = int(tr.fd.valid.sum().item()) * cfg.local_ep

    # expected launches. Warp: two weak views per real stage-1 step, one per
    # stage-2 step (a hoisted round: one launch a view for the whole round;
    # the lockstep and stacked engines: one launch a view a plan step, for
    # all K·B images), one per harvest chunk and client (one sweep in the
    # last stage-1 round, two in a stage-2 round). Depthwise kernels
    # (dw_backend='pallas', not on the stacked forward): one launch of each
    # per depthwise layer (16) and train-mode forward that gets a backward:
    # two per real stage-1 step (one with view_concat='on'), one per stage-2
    # step; padding steps and eval-mode forwards add none.
    valid = tr.fd.valid.cpu().numpy()
    steps = sum(int(math.ceil(n / B)) for n in valid.sum(1)) * cfg.local_ep
    chunks = n_clients * int(math.ceil(valid.shape[1] / (4 * B)))
    n_stage2 = n_rounds - stage1_rounds
    stage2_engine = "mapped" if cfg.fedmlp.mixup else tr.engine

    def view_launches(n_views: int, engine: str) -> int:
        if hoisted(tr, n_views):
            return n_views
        return n_views * (steps if engine == "mapped" else plan_steps(tr))

    stage1_forwards = 1 if cfg.view_concat == "on" else 2
    train_forwards = stage1_forwards * steps * stage1_rounds + steps * n_stage2
    dw = 16 * train_forwards if cfg.dw_backend == "pallas" and tr.engine != "stacked" else 0
    expected = {
        "fused_warp_normalize": (stage1_rounds * view_launches(2, tr.engine)
                                 + n_stage2 * view_launches(1, stage2_engine)
                                 + chunks + 2 * chunks * n_stage2),
        "dw_dgrad": dw, "dw_wgrad": dw,
    }
    print(f"phase {path}: engine {tr.engine} (stage 2 {stage2_engine}), "
          f"view_concat={cfg.view_concat} hoist_augment={cfg.hoist_augment}: "
          f"stage 1 hoisted {hoisted(tr, 2)}, stage 2 hoisted {hoisted(tr, 1)}; "
          f"{stage1_forwards} train forward(s) a stage-1 step")
    if count_eval:  # the test transform, one launch a chunk of 4B images
        expected["normalize_flip_cutout"] = int(math.ceil(len(tr.test_ds) / (4 * B)))
    if on_trainer is not None:
        on_trainer(tr)

    reset_launch_counts()
    losses = []
    for rnd in range(n_rounds):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        rec = tr.run_round(rnd)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        losses.extend(rec.client_losses)
        ROUND_SECONDS.setdefault(path, []).append(secs)
        PEAK_GIB.setdefault(path, []).append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"phase {path}: round {rnd} (stage {1 if rnd < stage1_rounds else 2}) "
              f"{secs:.3f} s {imgs_per_round / secs:.1f} img/s "
              f"mean loss {sum(rec.client_losses) / n_clients:.5f} "
              f"dw_backend={cfg.dw_backend or 'conv'} peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if not count_eval:
        launches = read_launch_counts()
    metrics = tr.evaluate()
    torch.cuda.synchronize()
    if count_eval:
        launches = read_launch_counts()
    print(f"phase {path}: global_test {json.dumps(metrics)}")

    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite client losses: {losses}")
    off = [n for n, p in tr.model.named_parameters() if p.device.type != "cuda"]
    if off:
        raise SystemExit(f"parameters off the card: {off[:5]}")
    for key in ("tao", "proto"):
        v = tr.server_state[key]
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise SystemExit(f"non-finite server state {key}")
    width = tr.server_state["proto"].shape[1]
    print(f"phase {path}: feature width {width} ({cfg.model})")
    if width != feature_dim_of(cfg.model):
        raise SystemExit(f"{path}: prototypes {width} wide, {cfg.model} has "
                         f"{feature_dim_of(cfg.model)}")
    print(f"phase {path}: tagged cells {int((tr.server_state['tags'] > 0).sum())}")
    check_launches(path, launches, expected)
    return launches


def phase_slice(dev, card: str) -> dict:
    """Two stage-1 rounds (the second harvests) and one stage-2 round at the
    flagship geometry, default depthwise backend."""
    return run_flagship("slice", dev, card, flagship_config(K, N), 2, 3)


def print_beside_slice(path: str, card: str, n_images: int = N,
                       base_path: str = "slice", base_images: int = N) -> None:
    """Each round of ``path`` (``n_images`` a round) beside ``base_path``'s
    round of the same index from this run (``base_images`` a round):
    seconds, images/s and peak memory."""
    base, base_peak = ROUND_SECONDS.get(base_path), PEAK_GIB.get(base_path)
    for rnd, t in enumerate(ROUND_SECONDS[path]):
        other = (f"{base_path} round {rnd} {base[rnd]:.3f} s "
                 f"({base_images / base[rnd]:.1f} img/s, "
                 f"peak {base_peak[rnd]:.2f} GiB)" if base and rnd < len(base) else "nothing")
        print(f"phase {path}: round {rnd} {t:.3f} s ({n_images / t:.1f} img/s, peak "
              f"{PEAK_GIB[path][rnd]:.2f} GiB) beside {other} [{card}]")


# the lockstep gate: client losses of one round against the per-client
# loop's, relative (float32, TF32 off; the frozen-global forward runs at
# K·B = 128 images against 32, which may pick another cuDNN algorithm)
LOCKSTEP_REL_TOL = 1e-4


def phase_slice_lockstep(dev, card: str) -> dict:
    """The flagship with ``batched_global='on'``: two stage-1 rounds (one
    warp launch a view a plan step for all 640 images, the frozen global
    model once a view at batch 640) and one stage-2 round, each beside
    ``slice``'s. Then the gate: at K=4 (512 images), float32, 'normonly'
    views, one stage-1 round of the lockstep engine against the per-client
    loop (B0 without dropout or drop-connect, whose masks the engines draw
    in different orders), client losses within ``LOCKSTEP_REL_TOL``."""
    from fedmlp_tpu_torch.train import Trainer

    from fedmlp_tpu_torch.models import build_model

    class NoDropTrainer(Trainer):
        """B0 without dropout and drop-connect: the two engines draw their
        masks from the generator in different orders."""

        def _build_model(self):
            return build_model(self.cfg.model, self.cfg.n_classes, dropout_p=0.0,
                               drop_connect_rate=0.0)

    launches = run_flagship("slice_lockstep", dev, card,
                            flagship_config(K, N, batched_global="on"), 2, 3)
    print_beside_slice("slice_lockstep", card)
    losses = {}
    for mode in ("off", "on"):
        cfg = flagship_config(4, 4 * 128, compute_dtype="float32",
                              augment_backend="normonly", batched_global=mode)
        tr = NoDropTrainer(cfg, device=dev)
        losses[mode] = np.asarray(tr.run_round(0).client_losses)
        del tr
    err = float(np.max(np.abs(losses["on"] - losses["off"]) / np.abs(losses["off"])))
    print(f"phase slice_lockstep: gate K=4 float32 normonly, one stage-1 round: client "
          f"losses lockstep {losses['on'].tolist()} loop {losses['off'].tolist()}, "
          f"largest relative difference {err:.3e} (tol {LOCKSTEP_REL_TOL:g}) [{card}]")
    if not err <= LOCKSTEP_REL_TOL:
        raise SystemExit(f"slice_lockstep: lockstep losses off the loop's by {err}")
    return launches


def phase_slice_stacked(dev, card: str) -> dict:
    """FedMLP with ``client_stacking='on'`` at the flagship geometry, two
    stage-1 rounds and one stage-2 round (one stacked forward and backward a
    step for all clients), each beside ``slice``'s with its peak memory.
    Then the gate: a float32 stacked forward of B0 at 224 px, B=4, over K=2
    clients of different weights, in eval and in train mode, within
    ``ZOO_REL_TOL`` of the largest magnitude of the per-client forwards'
    logits."""
    from fedmlp_tpu_torch.models import build_model, init_model
    from fedmlp_tpu_torch.models.stacked import stacked_apply

    import gc

    for n_clients in (K, 10, 5):  # K cut only if the card's memory forces it
        try:
            launches = run_flagship("slice_stacked", dev, card, flagship_config(
                n_clients, n_clients * N // K, client_stacking="on"), 2, 3)
            break
        except torch.cuda.OutOfMemoryError:
            print(f"phase slice_stacked: K={n_clients} does not fit in the card's "
                  f"memory [{card}]")
            ROUND_SECONDS.pop("slice_stacked", None)
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise SystemExit("slice_stacked: not even K=5 fits")
    print(f"phase slice_stacked: K={n_clients} clients of {N // K} images")
    print_beside_slice("slice_stacked", card, n_clients * N // K)
    models = [init_model(build_model("efficient_b0", N_CLASSES), seed).to(dev)
              for seed in (0, 1)]
    sv = {n: torch.stack([m.state_dict()[n] for m in models])
          for n in models[0].state_dict()}
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x = torch.randn((2, 4, 3, SIZE, SIZE), generator=g, device=dev)
    for train in (False, True):
        with torch.no_grad():
            (_, logits), _ = stacked_apply(models[0], sv, x, train=train)
            errs = [_rel_err(logits[k], m.train(train)(x[k])[1])
                    for k, m in enumerate(models)]
        print(f"phase slice_stacked: gate B0 {SIZE} px float32 K=2 B=4 "
              f"{'train' if train else 'eval'}: logits relative error "
              f"{max(errs):.3e} (tol {ZOO_REL_TOL:g}) [{card}]")
        if not max(errs) <= ZOO_REL_TOL:
            raise SystemExit(f"slice_stacked: stacked forward off the per-client "
                             f"forwards by {max(errs)}")
    return launches


def phase_slice_dw(dev, card: str) -> dict:
    """The same geometry with ``dw_backend='pallas'``: one stage-1 round
    (which harvests) and one stage-2 round, the depthwise backward through
    ``dw_dgrad`` and ``dw_wgrad``."""
    launches = run_flagship(
        "slice_dw", dev, card, flagship_config(K, N, 1, "pallas"), 1, 2)
    secs, conv_seconds = ROUND_SECONDS["slice_dw"], ROUND_SECONDS.get("slice")
    if conv_seconds:
        print(f"phase slice_dw: stage 1 + harvest {secs[0]:.3f} s, stage 2 "
              f"{secs[1]:.3f} s with dw_backend='pallas'; default backend "
              f"{conv_seconds[1]:.3f} s and {conv_seconds[2]:.3f} s (phase slice, "
              f"rounds 1 and 2) [{card}]")
    return launches


def phase_slice_views(dev, card: str) -> dict:
    """The flagship geometry with ``dw_backend='pallas'``, ``view_concat=
    'on'`` and ``hoist_augment=1``: two stage-1 rounds (one 2B forward a
    step; not hoisted, 5120 view images) and one stage-2 round (hoisted:
    its 2560 views in one launch). Each round beside ``slice``'s and
    ``slice_dw``'s of the same stage from this run."""
    cfg = flagship_config(K, N, 2, "pallas", view_concat="on", hoist_augment=1)
    launches = run_flagship("slice_views", dev, card, cfg, 2, 3)
    secs = ROUND_SECONDS["slice_views"]
    slice_seconds, dw_seconds = ROUND_SECONDS.get("slice"), ROUND_SECONDS.get("slice_dw")
    imgs = N  # every client's images, once a round
    for rnd, t in enumerate(secs):
        stage = 1 if rnd < 2 else 2
        base = [f"slice round {rnd} {slice_seconds[rnd]:.3f} s "
                f"({imgs / slice_seconds[rnd]:.1f} img/s)"] if slice_seconds else []
        if dw_seconds:
            j = 0 if stage == 1 else 1
            base.append(f"slice_dw round {j} ({'stage 1 + harvest' if j == 0 else 'stage 2'}) "
                        f"{dw_seconds[j]:.3f} s ({imgs / dw_seconds[j]:.1f} img/s)")
        print(f"phase slice_views: round {rnd} (stage {stage}) {t:.3f} s "
              f"({imgs / t:.1f} img/s) beside {'; '.join(base) or 'nothing'} [{card}]")
    return launches


# the paths of slice_knobs and time_knobs: (path, Config fields)
KNOBS = (
    ("slice_taps", dict(dw_backend="taps")),
    ("slice_dense", dict(dw_backend="dense")),
    ("slice_reroute", dict(dw_backend="reroute")),
    ("slice_remat", dict(remat=1)),
    ("slice_remat_stages", dict(remat_stages="0,1")),
    ("slice_weight_stream", dict(weight_stream=1)),
)
# time_knobs' yardstick: the same trainer without a knob, run first
KNOBS_OFF = ("slice_knobs_off", {})
# clients of the knob trainers, 128 images each as the flagship's: one in
# slice_knobs (4 steps drive and count each path), four in time_knobs
KNOB_CLIENTS = 1
TIME_KNOB_CLIENTS = 4
# the remat gate: logits, gradients and running statistics of a remat step
# against the step without, each set relative to its largest magnitude
REMAT_REL_TOL = 1e-6


def run_stage1_round(path: str, dev, card: str, cfg) -> dict:
    """One counted stage-1 round (round 0 of ``cfg``'s two: no harvest, no
    evaluation) of the FedMLP ``Trainer``, launch counts set to 0 just
    before and read just after: two weak views a real step, nothing else.
    Its seconds go to ``ROUND_SECONDS[path]``, its peak to
    ``PEAK_GIB[path]``."""
    from fedmlp_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase {path}: setup {time.perf_counter() - t0:.2f} s")
    valid = tr.fd.valid.cpu().numpy()
    steps = sum(int(math.ceil(n / B)) for n in valid.sum(1)) * cfg.local_ep
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    rec = tr.run_round(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ROUND_SECONDS[path] = [secs]
    PEAK_GIB[path] = [peak]
    print(f"phase {path}: round 0 (stage 1) {secs:.3f} s "
          f"{int(valid.sum()) * cfg.local_ep / secs:.1f} img/s mean loss "
          f"{sum(rec.client_losses) / tr.n_clients:.5f} peak memory {peak:.2f} GiB "
          f"[{card}]")
    if not all(math.isfinite(x) for x in rec.client_losses):
        raise SystemExit(f"{path}: non-finite client losses {rec.client_losses}")
    check_launches(path, launches, {"fused_warp_normalize": 2 * steps})
    return launches


def _relative(a: dict, b: dict) -> float:
    """The largest difference between the tensors of ``a`` and ``b`` (same
    names) over the largest magnitude of ``b``'s: one scale for a whole set,
    since some gradients are zero but for rounding (a batch-norm bias
    followed by a convolution and another batch norm)."""
    diff = max(float((a[n].double() - b[n].double()).abs().max()) for n in b)
    return diff / max(float(b[n].abs().max()) for n in b)


def _train_step(model, x, ct, generator=None, params=None):
    """A train-mode forward of ``model`` (through ``functional_call`` on
    ``params`` where given), then the backward of ``ct`` from the logits:
    (logits, {name: gradient}, {name: buffer})."""
    from fedmlp_tpu_torch.parallel.fl_runtime import _LossCall

    model.train()
    for p in model.parameters():
        p.grad = None
    if params is None:
        _, logits = model(x, generator)
    else:
        call = _LossCall(model, lambda m, x, g: m(x, g)[1])
        logits = torch.func.functional_call(call, params, (x, generator))
    logits.float().backward(ct)
    return (logits.detach().float(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def knob_gates(dev, card: str) -> None:
    """The gates of slice_knobs, on the card after the counted span; each
    failure raises.

    (a) Each new depthwise backend's train-mode B0 forward and backward
    against 'conv' from one state dict, float32, TF32 off, B=4 at 224 px:
    the logits, and all parameter gradients, within ``ZOO_REL_TOL`` of the
    largest magnitude of 'conv''s (``_relative``).
    (b) A remat step (every block, and stages 0 and 1) against the step
    without, B0 with drop-connect from a generator and ResNet-18, bf16
    autocast, B=8 at 224 px, cuDNN deterministic: the loss, every gradient
    and every running statistic within ``REMAT_REL_TOL``; the print says
    whether they were equal bits. Each set (logits, gradients, statistics)
    is measured as ``_relative`` measures it.
    (c) A ``weight_stream`` step (``streamed_params`` through
    ``functional_call``) against the step on parameters rounded to bf16
    first, B0, bf16 autocast, cuDNN deterministic: the logits within
    ``REMAT_REL_TOL``, the gradients within one bf16 ulp (2⁻⁸) of the
    largest magnitude of the reference's, rounded to bf16 (the cotangent
    of JAX's cast), buffers float32."""
    from fedmlp_tpu_torch.models import build_model, init_model
    from fedmlp_tpu_torch.parallel.fl_runtime import streamed_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x4 = torch.randn((4, 3, SIZE, SIZE), generator=g, device=dev)
    ct4 = torch.randn((4, N_CLASSES), generator=g, device=dev)
    sd = init_model(build_model("efficient_b0", N_CLASSES), 3).state_dict()
    ref = None
    for backend in ("conv", "taps", "dense", "reroute"):
        t0 = time.perf_counter()
        m = build_model("efficient_b0", N_CLASSES, dw_backend=backend)
        m.load_state_dict(sd)
        out = _train_step(m.to(dev), x4, ct4)
        if ref is None:
            ref = out
            continue
        err = max(_relative({"y": out[0]}, {"y": ref[0]}), _relative(out[1], ref[1]))
        print(f"phase slice_knobs: gate dw_backend={backend} against 'conv', B0 "
              f"float32 (TF32 off) train B=4 {SIZE} px: logits and gradients "
              f"relative error {err:.3e} (tol {ZOO_REL_TOL:g}; "
              f"{time.perf_counter() - t0:.1f} s) [{card}]")
        if not err <= ZOO_REL_TOL:
            raise SystemExit(f"slice_knobs: dw_backend={backend} off 'conv' by {err}")

    x8 = torch.randn((8, 3, SIZE, SIZE), generator=g, device=dev)
    ct8 = torch.randn((8, N_CLASSES), generator=g, device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, kws in (("efficient_b0", (dict(remat=True), dict(remat_stages=(0, 1)))),
                          ("resnet18", (dict(remat=True),))):
            t0 = time.perf_counter()
            sd = init_model(build_model(name, N_CLASSES), 4).state_dict()
            outs = []
            for kw in ({},) + kws:
                m = build_model(name, N_CLASSES, **kw)
                m.load_state_dict(sd)
                gen = torch.Generator(device=dev)
                gen.manual_seed(9)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    outs.append(_train_step(m.to(dev), x8, ct8, gen) + (gen.get_state(),))
            for kw, out in zip(kws, outs[1:]):
                errs = [_relative({"y": out[0]}, {"y": outs[0][0]}),
                        _relative(out[1], outs[0][1]), _relative(out[2], outs[0][2])]
                same = (all(torch.equal(out[i][n], outs[0][i][n])
                            for i in (1, 2) for n in outs[0][i])
                        and torch.equal(out[0], outs[0][0]))
                print(f"phase slice_knobs: gate {name} {kw} against no remat, bf16 "
                      f"train B=8 {SIZE} px, cuDNN deterministic: loss, gradients and "
                      f"running statistics relative error {max(errs):.3e} (tol "
                      f"{REMAT_REL_TOL:g}), equal bits {same}, generator state equal "
                      f"{torch.equal(out[3], outs[0][3])} ({name}: "
                      f"{time.perf_counter() - t0:.1f} s) [{card}]")
                if not (max(errs) <= REMAT_REL_TOL and torch.equal(out[3], outs[0][3])):
                    raise SystemExit(f"slice_knobs: {name} {kw} off no remat by {max(errs)}")

        t0 = time.perf_counter()
        sd = init_model(build_model("efficient_b0", N_CLASSES), 6).state_dict()
        m = build_model("efficient_b0", N_CLASSES).to(dev)
        m.load_state_dict(sd)
        rounded = {n: v.to(torch.bfloat16).float() if v.is_floating_point() and n in
                   dict(m.named_parameters()) else v for n, v in sd.items()}
        outs = []
        for streamed in (True, False):
            m.load_state_dict(sd if streamed else rounded)
            gen = torch.Generator(device=dev)
            gen.manual_seed(9)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                outs.append(_train_step(
                    m, x8, ct8, gen,
                    streamed_params(m, torch.bfloat16) if streamed else None))
        (ls, gs, bs), (lr_, gr, _) = outs
        want = {n: v.to(torch.bfloat16).float() for n, v in gr.items()}
        err = _relative({"y": ls}, {"y": lr_})
        gerr = _relative(gs, want)
        same = all(torch.equal(gs[n], want[n]) for n in gr)
        f32 = all(b.dtype == torch.float32 for n, b in bs.items() if b.is_floating_point())
        print(f"phase slice_knobs: gate weight_stream against the step on parameters "
              f"rounded to bf16, B0 bf16 train B=8 {SIZE} px, cuDNN deterministic: "
              f"logits relative error {err:.3e} (tol {REMAT_REL_TOL:g}), gradients "
              f"against the bf16-rounded reference {gerr:.3e} (tol {2.0 ** -8:g}), "
              f"equal bits {same}, buffers float32 {f32} "
              f"({time.perf_counter() - t0:.1f} s) [{card}]")
        if not (err <= REMAT_REL_TOL and gerr <= 2.0 ** -8 and f32):
            raise SystemExit(f"slice_knobs: weight_stream off the rounded step "
                             f"({err}, {gerr}, buffers float32 {f32})")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def knob_rounds(dev, card: str, n_clients: int, paths, yardstick: str = "") -> dict:
    """One counted stage-1 round (``run_stage1_round``) of the flagship
    geometry cut to ``n_clients`` clients with each of ``paths``' knobs,
    beside ``slice``'s round 0 and, where given, beside the round of the
    path ``yardstick``. Returns the launches by path."""
    import gc

    by_path = {}
    n_train = n_clients * N // K
    for path, kw in paths:
        by_path[path] = run_stage1_round(path, dev, card,
                                         flagship_config(n_clients, n_train, **kw))
        print_beside_slice(path, card, n_train)
        if yardstick and path != yardstick:
            print_beside_slice(path, card, n_train, yardstick, n_train)
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def phase_slice_knobs(dev, card: str) -> dict:
    """The model-side knobs through the ``Trainer``: one counted stage-1
    round each of ``dw_backend`` 'taps', 'dense' and 'reroute', ``remat=1``,
    ``remat_stages='0,1'`` and ``weight_stream=1`` at the flagship geometry
    with ``KNOB_CLIENTS`` client (round 0 of two, so no harvest); then
    ``knob_gates``. Returns the launches by path."""
    t0 = time.perf_counter()
    by_path = knob_rounds(dev, card, KNOB_CLIENTS, KNOBS)
    t1 = time.perf_counter()
    knob_gates(dev, card)
    print(f"phase slice_knobs: rounds {t1 - t0:.1f} s, gates "
          f"{time.perf_counter() - t1:.1f} s [{card}]")
    return by_path


def phase_time_knobs(dev, card: str) -> None:
    """The knobs' rounds at ``TIME_KNOB_CLIENTS`` clients, each beside the
    round 0 of a trainer without a knob (``slice_knobs_off``, run first in
    this phase: ``slice``'s round 0 carries the process's first calls) and
    with its peak memory; the launches are checked as in slice_knobs."""
    knob_rounds(dev, card, TIME_KNOB_CLIENTS, (KNOBS_OFF,) + KNOBS, KNOBS_OFF[0])


def phase_slice_resnet18(dev, card: str) -> dict:
    """FedMLP on ResNet-18 (the reference's default, spelled 'Resnet18') at
    the flagship geometry, the data read from disk: the synthetic flagship
    set (2560 train, 64 test images) written with ``save_packed_dataset``
    into a temporary train/ and test/ and loaded back with
    ``load_packed_dataset``. Two stage-1 rounds (the second harvests), one
    stage-2 round with ``fedmlp.mixup``, then the evaluation, all inside the
    counted span."""
    import tempfile

    cfg = flagship_config(K, N, model="Resnet18", mixup=1)
    with tempfile.TemporaryDirectory() as root:
        datasets = packed_flagship("slice_resnet18", root, cfg.seed, N)
        # a stage-2 step mixes its one weak view after the warp: one launch
        launches = run_flagship("slice_resnet18", dev, card, cfg, 2, 3,
                                datasets=datasets, count_eval=True)
    return launches


def packed_flagship(path: str, root: str, seed: int, n_train: int) -> tuple:
    """The synthetic flagship set (``n_train`` training and ``N_TEST`` test
    images, 224 px, from ``seed``) written with ``save_packed_dataset`` into
    ``root``'s train/ and test/ and mapped back with ``load_packed_dataset``:
    (train, test)."""
    import os

    from fedmlp_tpu_torch.data.datasets import (load_packed_dataset,
                                                make_synthetic_dataset,
                                                save_packed_dataset)

    t0 = time.perf_counter()
    for part, n, sd in (("train", n_train, seed), ("test", N_TEST, seed + 1)):
        save_packed_dataset(make_synthetic_dataset(n, N_CLASSES, SIZE, seed=sd),
                            os.path.join(root, part))
    t1 = time.perf_counter()
    train_ds = load_packed_dataset(os.path.join(root, "train"))
    test_ds = load_packed_dataset(os.path.join(root, "test"))
    print(f"phase {path}: packed shard of {len(train_ds)} + {len(test_ds)} images at "
          f"{SIZE} px written in {t1 - t0:.2f} s, mapped back in "
          f"{time.perf_counter() - t1:.3f} s")
    return train_ds, test_ds


# host streaming: the counted path's window (steps of one client on the
# per-client loop), the gate's clients (of 128 images each) and the pinned
# buffer gate's submits
STREAM_WINDOW = 2
STREAM_GATE_CLIENTS = 2
PIN_GATE_SUBMITS = 50


def streamed(cfg, root: str, window: int):
    """``cfg`` reading its training images from ``<root>/train/images.npy``
    through the loader (``data.host_stream``), ``window`` steps at a time."""
    import dataclasses

    return cfg.replace(data=dataclasses.replace(cfg.data, root=root, host_stream=True,
                                                stream_window=window))


def stream_gates(dev, card: str, root: str) -> None:
    """The gates of slice_stream, each failure raising. (a) At
    ``STREAM_GATE_CLIENTS`` clients of 128 images, B0 224 px, float32, cuDNN
    deterministic, on the per-client loop and on the lockstep engine: one
    stage-1 round that harvests, resident against streamed with
    ``STREAM_WINDOW``: client losses, the global state dict, τ and the
    prototypes equal bit for bit. (b) The loader's pinned buffers:
    ``PIN_GATE_SUBMITS`` gathers of 64 random rows, alternately through
    ``submit``/``wait`` and ``gather``, each copied to the card behind a
    hold of the stream, all against ``gather_plain`` at the end. (c) A
    streamed stage-2 round of (a)'s loop trainer inside ``trace_round``:
    the trace lists CUDA kernels, the weak view's among them."""
    import glob
    import os

    from fedmlp_tpu_torch.data.native_loader import PackLoader, gather_plain
    from fedmlp_tpu_torch.train import Trainer
    from fedmlp_tpu_torch.utils.profiling import trace_round

    n_train = STREAM_GATE_CLIENTS * 128
    base = flagship_config(STREAM_GATE_CLIENTS, n_train, rounds_stage1=1,
                           compute_dtype="float32")
    datasets = packed_flagship("slice_stream", root, base.seed, n_train)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for engine in ("off", "on"):
            t0 = time.perf_counter()
            runs = []
            for cfg in (base, streamed(base, root, STREAM_WINDOW)):
                tr = Trainer(cfg.replace(batched_global=engine), train_ds=datasets[0],
                             test_ds=datasets[1], device=dev)
                losses = tr.run_round(0).client_losses
                runs.append((tr, losses))
            (res, l_res), (st, l_st) = runs
            same = (l_res == l_st
                    and all(torch.equal(v, st.global_vars[n])
                            for n, v in res.global_vars.items())
                    and all(np.array_equal(res.server_state[k], st.server_state[k])
                            for k in ("tao", "proto")))
            print(f"phase slice_stream: gate {tr.engine} engine K={STREAM_GATE_CLIENTS} "
                  f"B0 {SIZE} px float32, cuDNN deterministic, a stage-1 round with its "
                  f"harvest: streamed (window {STREAM_WINDOW}, peak "
                  f"{st.stream_peak_rows} rows) against resident, equal bits {same}, "
                  f"losses {l_st} ({time.perf_counter() - t0:.1f} s) [{card}]")
            if not same:
                raise SystemExit(f"slice_stream: the streamed {tr.engine} round is not "
                                 f"the resident one: {l_st} against {l_res}")
            if engine == "off":
                loop = st
            del runs, res, tr
    finally:
        torch.backends.cudnn.deterministic = deterministic

    npy = os.path.join(root, "train", "images.npy")
    mm = np.load(npy, mmap_mode="r")
    rng = np.random.RandomState(5)
    t0 = time.perf_counter()
    gather_s = []
    with PackLoader(npy, reuse_buffers=True) as ld:
        got, rows = [], []
        for i in range(PIN_GATE_SUBMITS):
            rows.append(rng.choice(n_train, 64, replace=False))
            if i % 2:
                t1 = time.perf_counter()
                host = ld.gather(rows[-1])
                gather_s.append(time.perf_counter() - t1)
            else:
                ld.submit(rows[-1])
                host = ld.wait()
            torch.cuda._sleep(HOLD_CYCLES)  # the copy waits; the next call may not
            got.append(ld.to_device(host, dev))
        torch.cuda.synchronize()
        bad = [i for i, (t, r) in enumerate(zip(got, rows))
               if not np.array_equal(t.cpu().numpy(), gather_plain(mm, r))]
    print(f"phase slice_stream: gate pinned buffers, {PIN_GATE_SUBMITS} gathers of 64 "
          f"rows (submit/wait and gather in turns), each copy behind a hold: "
          f"{PIN_GATE_SUBMITS - len(bad)} equal to gather_plain; a gather of a "
          f"window's 64 rows ({64 * SIZE * SIZE * 3 / 2**20:.1f} MiB) "
          f"{1e3 * statistics.median(gather_s):.2f} ms median "
          f"({time.perf_counter() - t0:.2f} s) [{card}]")
    if bad:
        raise SystemExit(f"slice_stream: pinned-buffer copies {bad} differ from the shard")

    out = os.path.join(root, "trace")
    t0 = time.perf_counter()
    with trace_round(out):
        loop.run_round(1)
    (path,) = glob.glob(os.path.join(out, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    warp = sum("fused_warp" in k for k in kernels)
    print(f"phase slice_stream: a traced streamed stage-2 round (K="
          f"{STREAM_GATE_CLIENTS}): {len(kernels)} CUDA kernel events, {warp} of the "
          f"weak view, trace {os.path.getsize(path) / 2**20:.1f} MiB "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if not warp:
        raise SystemExit("slice_stream: the trace lists no weak-view kernel")


def span_total(records, name: str, clock: str = "host") -> tuple:
    """(calls, seconds) of the span ``name`` over the round records
    ``records`` (``RoundRecord.spans``), on the host's clock or, for the
    spans that keep one, the device's (``utils/profiling.py``)."""
    from fedmlp_tpu_torch.utils import profiling

    profiling.resolve()
    spans = [r["spans"][name] for r in records if name in r["spans"]]
    return (sum(s["calls"] for s in spans),
            sum(s[f"{clock}_ns"] for s in spans) / 1e9)


def phase_slice_stream(dev, card: str) -> dict:
    """FedMLP at the flagship geometry (B0 224 px, K=20, batch 32, bf16) with
    its training images streamed from a packed shard on disk: after the
    gates (``stream_gates``), the flagship set written with
    ``save_packed_dataset``, then ``host_stream`` with ``STREAM_WINDOW``
    (each client's 4 steps in 2 windows of 64 images): a stage-1 round that
    harvests through the loader, a stage-2 round (two streamed harvests)
    and the evaluation, all counted. The images never reach the card as a
    table; at most two windows are held at once; each round beside
    ``slice``'s of its kind, and the shares the program's spans give: the
    rounds' host seconds (each ends in its read of the losses), the
    harvests' device seconds, the loader waits' host seconds."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        stream_gates(dev, card, os.path.join(root, "gate"))
        cfg = streamed(flagship_config(K, N, rounds_stage1=1), root, STREAM_WINDOW)
        datasets = packed_flagship("slice_stream", root, cfg.seed, N)
        held = {}

        def on_trainer(tr):
            if tr.fd.images is not None or tr.loader is None:
                raise SystemExit("slice_stream: the training table is on the card")
            held["tr"] = tr

        launches = run_flagship("slice_stream", dev, card, cfg, 1, 2, datasets=datasets,
                                count_eval=True, on_trainer=on_trainer)
    tr = held["tr"]
    bound = 2 * STREAM_WINDOW * B
    print(f"phase slice_stream: at most {tr.stream_peak_rows} image rows held at once "
          f"(bound 2·W·B = {bound}; the resident table {N} rows, "
          f"{N * SIZE * SIZE * 3 / 2**30:.2f} GiB) [{card}]")
    if not 0 < tr.stream_peak_rows <= bound:
        raise SystemExit(f"slice_stream: {tr.stream_peak_rows} rows held, bound {bound}")
    from fedmlp_tpu_torch.utils import profiling as P

    records = [r.spans for r in tr.history]
    n_rounds, rounds = span_total(records, P.ROUND)
    n_harvest, harvest = span_total(records, P.HARVEST, "device")
    n_wait, wait = span_total(records, P.LOADER_WAIT)
    print(f"phase slice_stream: spans over {n_rounds} rounds, {rounds:.3f} s: train "
          f"{rounds - harvest:.3f} s ({(rounds - harvest) / rounds:.3f}), harvest "
          f"{harvest:.3f} device s ({harvest / rounds:.3f}, {n_harvest} calls), loader "
          f"wait {wait:.3f} s ({wait / rounds:.3f}, {n_wait} calls, "
          f"{1e3 * wait / max(n_wait, 1):.2f} ms a call) [{card}]")
    base, base_peak = ROUND_SECONDS.get("slice"), PEAK_GIB.get("slice")
    for rnd, kind, other in ((0, "stage 1 + harvest", 1), (1, "stage 2", 2)):
        t = ROUND_SECONDS["slice_stream"][rnd]
        beside = (f"slice round {other} {base[other]:.3f} s ({N / base[other]:.1f} img/s, "
                  f"peak {base_peak[other]:.2f} GiB)" if base else "nothing")
        print(f"phase slice_stream: round {rnd} ({kind}) {t:.3f} s ({N / t:.1f} img/s, "
              f"peak {PEAK_GIB['slice_stream'][rnd]:.2f} GiB) beside {beside} [{card}]")
    print(f"phase slice_stream: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# ----------------------------------------------------------------------
# slice_mesh: the process mesh (parallel/mesh.py), two ranks sharing the one
# card through gloo (NCCL refuses two ranks on one GPU)
# ----------------------------------------------------------------------

MESH_RANKS = 2
# the sharded lockstep round against one rank's: the frozen-global forward
# runs at Kl·B = 64 images against K·B = 128, which may pick another cuDNN
# algorithm
MESH_LOCKSTEP_REL_TOL = 1e-6
# the same runs' gathered global variables (``_relative``: one scale for the
# set), after Adam, whose step on a weight with a gradient that is zero but
# for rounding is ±lr whichever way the rounding points
MESH_LOCKSTEP_VARS_REL_TOL = 1e-3
# the data axis on the card against the same code's run on the CPU
# (float32; the CPU's is held to JAX's data-axis round by
# tests/test_torch_mesh.py). No one-rank run is the reference: as in JAX,
# each data shard's batch norm takes the statistics of its own rows.
MESH_DATA_REL_TOL = 1e-5
# images a chunk of the views made before a round (``pre_augment``)
PREAUG_CHUNK = 256


def _digest(tree: dict) -> str:
    """sha256 of a state dict's or server state's bytes, name by name."""
    import hashlib

    h = hashlib.sha256()
    for n in sorted(tree):
        v = tree[n]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            h.update(n.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _solo(trainer_cls):
    """``trainer_cls`` whose rounds run on one rank as under any mesh
    (client k on a generator of its own): the run a sharded one equals."""
    from fedmlp_tpu_torch.parallel.mesh import Mesh

    class Solo(trainer_cls):
        @property
        def round_mesh(self):
            return Mesh(1, 1, device=self.device)

    return Solo


def _mesh_run(tr, n_rounds: int) -> dict:
    losses = [tr.run_round(r).client_losses for r in range(n_rounds)]
    return {"losses": losses, "vars": _digest(tr.global_vars),
            "state": _digest(tr.server_state),
            "global_vars": {n: v.cpu() for n, v in tr.global_vars.items()}}


def mesh_gates(dev) -> dict:
    """The gates, in every rank: (1) FedMLP on B0 at 224 px, K=3 over the
    two ranks, float32, views drawn, cuDNN deterministic, 1 stage-1 round
    that harvests and 1 stage-2 round, against the same rounds on one rank
    (rank 0); (2) the lockstep engine, K=4, 'normonly', a dropout-free B0,
    against one rank; (3) the data axis (1 x 2): FedAVG on smallcnn, K=2,
    'normonly', on the card and on the CPU."""
    from fedmlp_tpu_torch.config import Config, DataConfig, MeshConfig
    from fedmlp_tpu_torch.models import build_model
    from fedmlp_tpu_torch.parallel.mesh import process_rank
    from fedmlp_tpu_torch.train import Trainer

    class NoDropTrainer(Trainer):
        def _build_model(self):
            return build_model(self.cfg.model, self.cfg.n_classes, dropout_p=0.0,
                               drop_connect_rate=0.0)

    rank, out = process_rank(), {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = flagship_config(3, 3 * 64, rounds_stage1=1, compute_dtype="float32")
        runs = {"sharded": _mesh_run(Trainer(cfg, device=dev), 2)}
        if rank == 0:
            runs["solo"] = _mesh_run(_solo(Trainer)(cfg, device=dev), 2)
            runs["max_rel"] = _relative(runs["sharded"]["global_vars"],
                                        runs["solo"]["global_vars"])
        out["bits"] = runs
        # views before the round, sharded: FixMatch's drawn ones made before
        # the round, FedMLP's hoisted ones (gates 4 and 5)
        for name, cfg, n_rounds in (
                ("fixmatch_pre", strong_config("fixmatch", 3, 1, pre_augment=PREAUG_CHUNK,
                                               compute_dtype="float32"), 1),
                ("fedmlp_hoist", flagship_config(3, 3 * 64, rounds_stage1=1,
                                                 compute_dtype="float32",
                                                 hoist_augment=1), 2)):
            tr = Trainer(cfg, device=dev)
            runs = {"sharded": _mesh_run(tr, n_rounds)}
            if rank == 0:
                runs["solo"] = _mesh_run(_solo(Trainer)(cfg, device=dev), n_rounds)
            out[name] = runs
            if name == "fixmatch_pre":
                out["views"] = {"equal": rank_views_are_slices(tr)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cfg = flagship_config(4, 4 * 64, rounds_stage1=1, compute_dtype="float32",
                          augment_backend="normonly", batched_global="on")
    runs = {"sharded": _mesh_run(NoDropTrainer(cfg, device=dev), 2)}
    if rank == 0:
        runs["solo"] = _mesh_run(_solo(NoDropTrainer)(cfg, device=dev), 2)
        runs["max_rel"] = _relative(runs["sharded"]["global_vars"],
                                    runs["solo"]["global_vars"])
    out["lockstep"] = runs
    data_cfg = Config(algorithm="fedavg", model="smallcnn", batch_size=8, base_lr=1e-3,
                      n_clients=2, local_ep=1, rounds_warmup=1, eval_every=100, seed=5,
                      p_pos=0.0, compute_dtype="float32", output_dir="",
                      mesh=MeshConfig(data_axis=MESH_RANKS),
                      data=DataConfig(name="synthetic", n_classes=4, image_size=32,
                                      synthetic_train_size=64, synthetic_test_size=16,
                                      augment_backend="normonly"))
    runs = {}
    for where in (dev, "cpu"):
        tr = Trainer(data_cfg, device=where)
        if tr.round_mesh.data_shards != MESH_RANKS:
            raise SystemExit(f"slice_mesh: the data gate ran on {tr.round_mesh}")
        runs[str(torch.device(where).type)] = _mesh_run(tr, 1)
    runs["max_rel"] = _relative(runs["cuda"]["global_vars"], runs["cpu"]["global_vars"])
    out["data_axis"] = runs
    for part in out.values():
        for run in part.values():
            if isinstance(run, dict):
                run.pop("global_vars")
    return out


def rank_views_are_slices(tr) -> bool:
    """Whether this rank's views of a fresh round plan of ``tr`` (its block
    of clients and rows, ``pre_augment_views`` with the block's place) are,
    bit for bit, the slice at its block of the views of the whole round
    made in this process from the same generator state."""
    from fedmlp_tpu_torch.parallel import fl_runtime as rt

    K, b = tr.n_clients, tr.cfg.batch_size
    place = tr.round_mesh.place(K, b)
    mine, rows = slice(place.clients.start, place.clients.stop), place.rows
    pos, _, _ = rt.make_batch_plan(np.random.RandomState(0), tr.fd.valid.cpu().numpy(), b, 1)
    data = tr.cfg.data
    kw = dict(view_mode=tr.algo.VIEW_MODE, augment_backend=data.augment_backend,
              mean=data.mean, std=data.std, chunk=PREAUG_CHUNK)
    state = tr.generator.get_state()
    whole = rt.pre_augment_views(rt.gather_round_images(tr.fd.images, tr.fd.idx, pos),
                                 tr.generator, **kw)
    tr.generator.set_state(state)
    own = rt.pre_augment_views(
        rt.gather_round_images(tr.fd.images, tr.fd.idx[mine], pos[:, mine, rows]),
        tr.generator, place=place, **kw)
    return all(torch.equal(own[n], whole[n][:, mine, rows]) for n in whole)


def mesh_preaug(dev, card: str) -> dict:
    """FixMatch at ``slice_preaug``'s geometry (K=20, B0, bf16, 224 px,
    batch 32, ``pre_augment=256``) over the ranks: one round and the
    evaluation, each rank making the views of its clients before the round
    from the whole round's draws, with this rank's launch counts (reset just
    before, read just after), round seconds and peak, and the launches its
    clients imply and those of every rank's."""
    from fedmlp_tpu_torch.parallel.mesh import Mesh, process_rank
    from fedmlp_tpu_torch.train import Trainer

    rank = process_rank()
    tr = Trainer(strong_config("fixmatch", K, 1, pre_augment=PREAUG_CHUNK), device=dev)
    valid = tr.fd.valid.cpu().numpy()
    S = plan_steps(tr)

    def expected(clients) -> dict:
        # a chunk of the block's views: one warp launch (the weak view) and
        # nine shear passes (the strong view); a step's loss: two masked BCE
        # sums and their gradients; the evaluation: one normalize chunk
        chunks = int(math.ceil(S * len(clients) * B / PREAUG_CHUNK))
        steps = sum(int(math.ceil(valid[k].sum() / B)) for k in clients)
        return {"fused_warp_normalize": chunks, "hshift_rows": 9 * chunks,
                "bce_with_logits_masked_sum": 2 * steps,
                "bce_with_logits_masked_grad": 2 * steps, "normalize_flip_cutout": 1}

    blocks = [Mesh(MESH_RANKS, 1, r).client_block(tr.n_clients) for r in range(MESH_RANKS)]
    mine = blocks[rank]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run_round(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase slice_mesh_preaug: rank {rank} round 0 (evaluation included) "
          f"{seconds:.3f} s, clients {mine.start}-{mine.stop - 1}, peak {peak:.2f} GiB "
          f"[{card}]", flush=True)
    per_rank = [expected(b) for b in blocks]
    finite = (all(math.isfinite(x) for x in rec.client_losses)
              and bool(rec.metrics) and all(math.isfinite(v) for v in rec.metrics.values()))
    return {"launches": launches, "seconds": seconds, "peak": peak, "finite": finite,
            "clients": [mine.start, mine.stop], "expected_rank": per_rank[rank],
            "expected_all": {n: sum(e[n] for e in per_rank) for n in per_rank[0]},
            "metrics": rec.metrics, "vars": _digest(tr.global_vars)}


def mesh_flagship(dev, card: str) -> dict:
    """The flagship at ``slice``'s geometry (K=20, B0, bf16, 224 px, batch
    32, 128 images a client) over the ranks: one stage-1 round that
    harvests, one stage-2 round, the evaluation, with this rank's launch
    counts (reset just before, read just after), round seconds and peaks,
    and the launches its clients imply and those all 20 imply."""
    from fedmlp_tpu_torch.parallel.mesh import process_rank
    from fedmlp_tpu_torch.train import Trainer

    rank = process_rank()
    tr = Trainer(flagship_config(K, N, rounds_stage1=1), device=dev)
    valid = tr.fd.valid.cpu().numpy()
    mine = tr.round_mesh.client_block(tr.n_clients)

    def warp(clients) -> int:  # 2 views + 1 view a step; 1 + 2 harvest sweeps
        steps = sum(int(math.ceil(valid[k].sum() / B)) for k in clients)
        return 3 * steps + 3 * len(clients) * int(math.ceil(valid.shape[1] / (4 * B)))

    evals = int(math.ceil(len(tr.test_ds) / (4 * B)))
    torch.cuda.synchronize()
    reset_launch_counts()
    seconds, peaks, losses = [], [], []
    for rnd in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += tr.run_round(rnd).client_losses
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"phase slice_mesh: rank {rank} round {rnd} {seconds[-1]:.3f} s, clients "
              f"{mine.start}-{mine.stop - 1}, peak {peaks[-1]:.2f} GiB [{card}]", flush=True)
    metrics = tr.evaluate()
    torch.cuda.synchronize()
    launches = read_launch_counts()
    finite = (all(math.isfinite(x) for x in losses)
              and all(math.isfinite(v) for v in metrics.values())
              and all(bool(torch.isfinite(torch.as_tensor(tr.server_state[n])).all())
                      for n in ("tao", "proto")))
    return {"launches": launches, "seconds": seconds, "peaks": peaks, "finite": finite,
            "clients": [mine.start, mine.stop], "n_losses": len(losses),
            "tagged": int((tr.server_state["tags"] > 0).sum()),
            "expected_rank": {"fused_warp_normalize": warp(mine),
                              "normalize_flip_cutout": evals},
            "expected_all": {"fused_warp_normalize": warp(range(tr.n_clients)),
                             "normalize_flip_cutout": MESH_RANKS * evals},
            "metrics": metrics, "vars": _digest(tr.global_vars)}


def mesh_rank(card: str) -> dict:
    """What every rank of ``slice_mesh``'s group runs."""
    dev = "cuda"  # card LOCAL_RANK modulo the cards: the one card
    return {"gates": mesh_gates(dev), "flagship": mesh_flagship(dev, card),
            "preaug": mesh_preaug(dev, card)}


def nccl_check() -> dict:
    """A one-rank NCCL group: an all-reduce and a gather of CUDA tensors."""
    import torch.distributed as dist

    t = torch.arange(6.0, device="cuda")
    dist.all_reduce(t)
    parts = [torch.empty_like(t)]
    dist.all_gather(parts, t)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "reduced": t.tolist(),
            "gathered": parts[0].tolist()}


def phase_slice_mesh(dev, card: str) -> dict:
    """``slice_mesh``: two ranks sharing the card (gloo on CUDA tensors)
    run the gates and the flagship (``mesh_rank``); their launches are
    summed into the path's; then a one-rank NCCL group."""
    from fedmlp_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, (card,), device="cuda", timeout_s=600)
    print(f"phase slice_mesh: {MESH_RANKS} ranks done in {time.perf_counter() - t0:.1f} s")
    gates = [r["gates"] for r in ranks]
    bits = gates[0]["bits"]
    same = all(g["bits"]["sharded"] == bits["solo"] for g in gates)
    print(f"phase slice_mesh: gate 1, FedMLP B0 224 px K=3 float32 views drawn, 2 "
          f"shards against 1: equal bits {same} (largest relative difference "
          f"{bits['max_rel']:.3e}), losses {bits['sharded']['losses']} [{card}]")
    if not same:
        raise SystemExit("slice_mesh: the sharded FedMLP run is not the one-rank run")
    lock = gates[0]["lockstep"]
    a, b = (np.asarray(sum(lock[w]["losses"], [])) for w in ("sharded", "solo"))
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    ranks_agree = gates[1]["lockstep"]["sharded"] == lock["sharded"]
    print(f"phase slice_mesh: gate 2, lockstep K=4 float32 normonly, 2 shards against "
          f"1: client losses' largest relative difference {err:.3e} (tol "
          f"{MESH_LOCKSTEP_REL_TOL:g}), gathered global variables' {lock['max_rel']:.3e} "
          f"(tol {MESH_LOCKSTEP_VARS_REL_TOL:g}), ranks agree {ranks_agree} [{card}]")
    if not (err <= MESH_LOCKSTEP_REL_TOL and lock["max_rel"] <= MESH_LOCKSTEP_VARS_REL_TOL
            and ranks_agree):
        raise SystemExit(f"slice_mesh: sharded lockstep off one rank's by {err} (losses), "
                         f"{lock['max_rel']} (variables)")
    data = [g["data_axis"] for g in gates]
    twins = all(d[w] == data[0][w] for d in data for w in ("cuda", "cpu"))
    print(f"phase slice_mesh: gate 3, data axis 1 x 2 (FedAVG smallcnn K=2): ranks hold "
          f"equal bits {twins}, card against CPU largest relative difference "
          f"{data[0]['max_rel']:.3e} (tol {MESH_DATA_REL_TOL:g}), losses card "
          f"{data[0]['cuda']['losses']} CPU {data[0]['cpu']['losses']} [{card}]")
    if not (twins and data[0]["max_rel"] <= MESH_DATA_REL_TOL):
        raise SystemExit("slice_mesh: the data axis failed its gate")
    for n, (name, what) in enumerate((
            ("fixmatch_pre", f"FixMatch B0 224 px K=3 float32 pre_augment={PREAUG_CHUNK}"),
            ("fedmlp_hoist", "FedMLP B0 224 px K=3 float32 hoist_augment=1")), 4):
        runs = gates[0][name]
        same = all(g[name]["sharded"] == runs["solo"] for g in gates)
        print(f"phase slice_mesh: gate {n}, {what}, views drawn, 2 shards against 1: "
              f"equal bits {same}, losses {runs['sharded']['losses']} [{card}]")
        if not same:
            raise SystemExit(f"slice_mesh: the sharded {name} run is not the one-rank run")
    views = [g["views"]["equal"] for g in gates]
    print(f"phase slice_mesh: gate 6, each rank's views made before the round (FixMatch "
          f"K=3, chunk {PREAUG_CHUNK}) are the slice of the whole round's views made in "
          f"one process from the same generator state: {views} [{card}]")
    if not all(views):
        raise SystemExit("slice_mesh: a rank's views are not the whole round's slice")

    flag = [r["flagship"] for r in ranks]
    for r, f in enumerate(flag):
        check_launches(f"slice_mesh rank {r}", f["launches"], f["expected_rank"])
        print(f"phase slice_mesh: rank {r} clients {f['clients']}, tagged cells "
              f"{f['tagged']}")
        if not f["finite"]:
            raise SystemExit(f"slice_mesh: rank {r} non-finite losses, metrics or state")
        ROUND_SECONDS[f"slice_mesh_rank{r}"] = f["seconds"]
        PEAK_GIB[f"slice_mesh_rank{r}"] = f["peaks"]
    if len({f["vars"] for f in flag}) != 1 or flag[0]["metrics"] != flag[1]["metrics"]:
        raise SystemExit("slice_mesh: the ranks' global models or metrics differ")
    summed = {n: sum(f["launches"][n] for f in flag) for n in flag[0]["launches"]}
    check_launches("slice_mesh", summed, flag[0]["expected_all"])
    print(f"phase slice_mesh: global_test {json.dumps(flag[0]['metrics'])}")
    base, base_peak = ROUND_SECONDS.get("slice"), PEAK_GIB.get("slice")
    for rnd in range(2):
        beside = (f"slice round {rnd + 1} {base[rnd + 1]:.3f} s, peak "
                  f"{base_peak[rnd + 1]:.2f} GiB" if base else "nothing")
        print(f"phase slice_mesh: round {rnd} (stage {rnd + 1}) " + ", ".join(
            f"rank {r} {f['seconds'][rnd]:.3f} s peak {f['peaks'][rnd]:.2f} GiB"
            for r, f in enumerate(flag)) + f" beside {beside} [{card}]")

    pre = [r["preaug"] for r in ranks]
    for r, f in enumerate(pre):
        check_launches(f"slice_mesh_preaug rank {r}", f["launches"], f["expected_rank"])
        if not f["finite"]:
            raise SystemExit(f"slice_mesh_preaug: rank {r} non-finite losses or metrics")
        ROUND_SECONDS[f"slice_mesh_preaug_rank{r}"] = [f["seconds"]]
        PEAK_GIB[f"slice_mesh_preaug_rank{r}"] = [f["peak"]]
    if len({f["vars"] for f in pre}) != 1 or pre[0]["metrics"] != pre[1]["metrics"]:
        raise SystemExit("slice_mesh_preaug: the ranks' global models or metrics differ")
    summed_pre = {n: sum(f["launches"][n] for f in pre) for n in pre[0]["launches"]}
    check_launches("slice_mesh_preaug", summed_pre, pre[0]["expected_all"])
    print(f"phase slice_mesh_preaug: the ranks' global variables and metrics equal "
          f"(digest {pre[0]['vars'][:16]}), global_test {json.dumps(pre[0]['metrics'])}; "
          f"round " + ", ".join(f"rank {r} {f['seconds']:.3f} s peak {f['peak']:.2f} GiB"
                                for r, f in enumerate(pre)) + f" [{card}]")

    nccl = launch(nccl_check, 1, device="cuda", timeout_s=120)[0]
    want = [float(v) for v in range(6)]
    print(f"phase slice_mesh: one-rank NCCL group: backend {nccl['backend']}, all-reduce "
          f"{nccl['reduced']}, gather {nccl['gathered']}")
    if nccl["backend"] != "nccl" or nccl["reduced"] != want or nccl["gathered"] != want:
        raise SystemExit("slice_mesh: the NCCL group failed its check")
    return {"slice_mesh": summed, "slice_mesh_preaug": summed_pre}


# the backbones of the models_zoo phase: (name, cosine head)
ZOO = (("resnet50", False), ("senet50", False), ("senet154", False), ("vgg16", False),
       ("dense121", False), ("resnet18", True))
# the card's float32 forward against the CPU's, the largest difference over
# the largest magnitude (TF32 off on the card): the two order their sums
# differently, and train-mode batch norm at B=4 carries it through each layer
ZOO_REL_TOL = 1e-3


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def phase_models_zoo(dev, card: str) -> dict:
    """Each backbone of ``ZOO`` at full width: (a) one model copied to the
    card and the CPU, a float32 forward of the same B=4, 224 px batch in eval
    and in train mode on both, feature and logits within ``ZOO_REL_TOL``;
    (b) one FedAVG round through the ``Trainer`` on the card, 2 clients x 64
    images, B=32, 224 px, bf16, the trainer's generator reaching dropout
    (VGG, SENet-154): finite losses, every parameter on the card, the
    round's seconds (the first round of its trainer, so cuDNN's first calls
    are in it, and the evaluation of the 64 test images) and peak memory.
    The launch counts are set to 0 before the rounds and read after them:
    one weak view a step, one test-transform chunk a round."""
    import copy

    from fedmlp_tpu_torch.config import Config, DataConfig
    from fedmlp_tpu_torch.models import build_model, init_model
    from fedmlp_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1037)
    x = torch.randn(4, 3, SIZE, SIZE, generator=g)
    reset_launch_counts()
    steps = 0
    for name, normed in ZOO:
        label = name + (" (cosine head)" if normed else "")
        t0 = time.perf_counter()
        cpu_model = init_model(build_model(name, N_CLASSES, normed_head=normed,
                                           image_size=SIZE), seed=1037)
        card_model = copy.deepcopy(cpu_model).to(dev)
        errs = {}
        for mode in ("eval", "train"):
            for m in (cpu_model, card_model):
                m.train(mode == "train")
            with torch.no_grad():
                want = cpu_model(x)
                got = card_model(x.to(dev))
            errs[mode] = (_rel_err(got[0], want[0]), _rel_err(got[1], want[1]))
        print(f"phase models_zoo: {label} card vs CPU, float32, B=4: eval feature "
              f"{errs['eval'][0]:.3e} logits {errs['eval'][1]:.3e}, train feature "
              f"{errs['train'][0]:.3e} logits {errs['train'][1]:.3e} (tol {ZOO_REL_TOL}; "
              f"{time.perf_counter() - t0:.1f} s)")
        if not all(e <= ZOO_REL_TOL for pair in errs.values() for e in pair):
            raise SystemExit(f"models_zoo: {label} card and CPU disagree: {errs}")
        del cpu_model, card_model

        class ZooTrainer(Trainer):
            def _build_model(self):  # the cosine head has no Config field
                return build_model(self.cfg.model, self.cfg.n_classes,
                                   normed_head=normed, image_size=SIZE)

        cfg = Config(algorithm="fedavg", model=name, batch_size=B, base_lr=3e-5,
                     n_clients=2, local_ep=1, rounds_warmup=1, eval_every=10**6,
                     seed=1037, p_pos=0.0, compute_dtype="bfloat16", output_dir="",
                     data=DataConfig(name="synthetic", n_classes=N_CLASSES,
                                     image_size=SIZE, synthetic_train_size=2 * 64,
                                     synthetic_test_size=N_TEST))
        tr = ZooTrainer(cfg, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        rec = tr.run_round(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        steps += client_steps(tr)
        off = [n for n, p in tr.model.named_parameters() if p.device.type != "cuda"]
        print(f"phase models_zoo: {label} FedAVG round, 2 clients x 64 images, bf16: "
              f"{secs:.3f} s, losses {rec.client_losses}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"{sum(p.numel() for p in tr.model.parameters())} parameters [{card}]")
        if (not all(math.isfinite(v) for v in rec.client_losses) or off or not rec.metrics
                or not all(math.isfinite(v) for v in rec.metrics.values())):
            raise SystemExit(f"models_zoo: {label} losses {rec.client_losses}, metrics "
                             f"{rec.metrics}, parameters off the card {off[:5]}")
        if normed and type(tr.model.head).__name__ != "FCNormHead":
            raise SystemExit("models_zoo: the cosine head did not reach the Trainer")
        del tr
        torch.cuda.empty_cache()
    launches = read_launch_counts()
    check_launches("models_zoo", launches, {"fused_warp_normalize": steps,
                                            "normalize_flip_cutout": len(ZOO)})
    return launches


def strong_config(algorithm: str, n_clients: int, rounds: int, **kw):
    """The ladder's FixMatch rung (tools/ladder.py ``baseline-fixmatch-
    20client`` through bench.py::_bench_fedavg): EfficientNet-B0, 224 px,
    batch 32, 8 classes, p_pos=0, bf16, synthetic, 128 images a client."""
    from fedmlp_tpu_torch.config import Config, DataConfig

    return Config(
        algorithm=algorithm, model="efficient_b0", batch_size=B, base_lr=3e-5,
        n_clients=n_clients, local_ep=1, rounds_warmup=rounds, eval_every=10**6,
        seed=1037, p_pos=0.0,
        data=DataConfig(name="synthetic", n_classes=N_CLASSES, image_size=SIZE,
                        synthetic_train_size=n_clients * 4 * B,
                        synthetic_test_size=N_TEST),
        **{"compute_dtype": "bfloat16", "output_dir": "", **kw})


def run_rounds(path: str, card: str, tr, n_rounds: int) -> list:
    """``n_rounds`` rounds of ``tr`` (the last one evaluates); finite losses
    and metrics, or SystemExit. Returns the seconds of each round."""
    imgs_per_round = int(tr.fd.valid.sum().item()) * tr.cfg.local_ep
    seconds = []
    for rnd in range(n_rounds):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        rec = tr.run_round(rnd)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        seconds.append(secs)
        ROUND_SECONDS.setdefault(path, []).append(secs)
        print(f"phase {path}: round {rnd} {secs:.3f} s {imgs_per_round / secs:.1f} img/s "
              f"mean loss {sum(rec.client_losses) / tr.n_clients:.5f}"
              f"{' evaluation included' if rec.metrics else ''} peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        if not all(math.isfinite(x) for x in rec.client_losses):
            raise SystemExit(f"{path}: non-finite client losses {rec.client_losses}")
    if not rec.metrics or not all(math.isfinite(v) for v in rec.metrics.values()):
        raise SystemExit(f"{path}: no or non-finite final metrics {rec.metrics}")
    print(f"phase {path}: global_test {json.dumps(rec.metrics)}")
    return seconds


def client_steps(tr) -> int:
    """Real local steps of one round, summed over the clients."""
    return sum(int(math.ceil(n / B)) for n in tr.fd.valid.sum(1).tolist()) * tr.cfg.local_ep


def run_path(path: str, dev, card: str, cfg, n_rounds: int, expected) -> tuple:
    """A ``Trainer`` at ``cfg``, ``n_rounds`` rounds (the last evaluates)
    with the launch counts set to 0 just before and read just after, held to
    ``expected(trainer)``. Returns (trainer, launches)."""
    from fedmlp_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase {path}: setup {time.perf_counter() - t0:.2f} s")
    reset_launch_counts()
    run_rounds(path, card, tr, n_rounds)
    launches = read_launch_counts()
    check_launches(path, launches, expected(tr))
    return tr, launches


def phase_slice_strong(dev, card: str) -> dict:
    """FedAVG+FixMatch, one round of 20 clients and the evaluation, then
    CBAFed, 4 clients, warm-up 1, two rounds. Returns the launch counts of
    each as a path of its own."""
    from fedmlp_tpu_torch.config import CBAFedConfig

    # a step makes the weak view with one warp launch and the strong view
    # with 3 shear passes for the affine prefix and 3 for each of the 2
    # RandAugment layers; its loss is two masked BCE sums, each one kernel
    # forward and one backward; the evaluation normalizes its 64 test images
    # in one chunk
    _, fixmatch = run_path("slice_strong", dev, card, strong_config("fixmatch", K, 1), 1,
                           lambda tr: {"fused_warp_normalize": client_steps(tr),
                                       "hshift_rows": 9 * client_steps(tr),
                                       "bce_with_logits_masked_sum": 2 * client_steps(tr),
                                       "bce_with_logits_masked_grad": 2 * client_steps(tr),
                                       "normalize_flip_cutout": 1})

    tr, cbafed = run_path(
        "slice_cbafed", dev, card,
        strong_config("cbafed", 4, 2, cbafed=CBAFedConfig(rounds_warmup=1)), 2,
        lambda tr: {"fused_warp_normalize": 2 * client_steps(tr), "normalize_flip_cutout": 1})
    tao = tr.server_state["tao"]
    print(f"phase slice_cbafed: tao {tao.tolist()}, residual of "
          f"{len(tr.server_state['residual'])} variables")
    if not hasattr(tr, "_cbafed_pseudo_fn"):
        raise SystemExit("slice_cbafed: the pseudo-label round did not run")
    if not ((tao >= 0.55) & (tao <= 0.95)).all():
        raise SystemExit(f"slice_cbafed: tao outside [0.55, 0.95]: {tao}")
    return {"slice_strong": fixmatch, "slice_cbafed": cbafed}


# the card's view against the CPU's on the same draws, the largest
# difference over the largest magnitude: the bilinear warps take their cos
# and sin in float64 and sharpness smooths in float64, so both run the same
# float32 operations and differ only where a reduction (contrast's mean)
# orders its sum otherwise
VIEW_REL_TOL = 1e-4


def phase_slice_preaug(dev, card: str) -> dict:
    """FedAVG+FixMatch, one round of 20 clients and the evaluation, with
    ``pre_augment=256``: before the round, the weak views of its S·K·B
    positions in one warp launch a 256-image chunk and the strong views in
    nine shear passes a chunk. Then (outside the counted span) the views of
    one round plan made with chunk=256 and chunk=2560 from one generator
    state, and RandAugmentPC and ``augment_pair`` (B=32, 224 px) on the card
    and on the CPU on the same draws."""
    from fedmlp_tpu_torch.ops import augment
    from fedmlp_tpu_torch.parallel import fl_runtime as rt

    chunk = PREAUG_CHUNK

    def expected(tr):
        n_chunks = int(math.ceil(views_positions(tr) / chunk))
        return {"fused_warp_normalize": n_chunks, "hshift_rows": 9 * n_chunks,
                "bce_with_logits_masked_sum": 2 * client_steps(tr),
                "bce_with_logits_masked_grad": 2 * client_steps(tr),
                "normalize_flip_cutout": 1}

    tr, launches = run_path("slice_preaug", dev, card,
                            strong_config("fixmatch", K, 1, pre_augment=chunk), 1, expected)
    strong = ROUND_SECONDS.get("slice_strong")
    print(f"phase slice_preaug: {views_positions(tr)} view positions in chunks of {chunk}; "
          f"round {ROUND_SECONDS['slice_preaug'][0]:.3f} s beside slice_strong's (views "
          f"in the step) {f'{strong[0]:.3f} s' if strong else 'not run'} [{card}]")

    pos, _, _ = rt.make_batch_plan(np.random.RandomState(0), tr.fd.valid.cpu().numpy(), B, 1)
    imgs = rt.gather_round_images(tr.fd.images, tr.fd.idx, pos)
    state = tr.generator.get_state()
    made = {}
    for c in (chunk, int(np.prod(pos.shape))):
        tr.generator.set_state(state)
        made[c] = rt.pre_augment_views(imgs, tr.generator, view_mode="weak_strong",
                                       augment_backend="auto", mean=MEAN, std=STD, chunk=c)
    a, b = made.values()
    x2_diff = (a["x2"] - b["x2"]).abs()
    n_x2 = int((x2_diff > 0).sum())
    x2_max = float(x2_diff.max())
    x1_equal = torch.equal(a["x1"], b["x1"])
    print(f"phase slice_preaug: views of {int(np.prod(pos.shape))} positions, chunk={chunk} "
          f"against one chunk: x1 equal bits {x1_equal}; x2 equal bits {n_x2 == 0}, "
          f"{n_x2} of {a['x2'].numel()} values differ, largest {x2_max:.3e} (tol 1e-5)")
    if not x1_equal or not x2_max <= 1e-5:
        raise SystemExit("slice_preaug: chunked views differ from one chunk")
    del made, a, b, x2_diff

    g = torch.Generator().manual_seed(1037)
    imgs_cpu = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=g, dtype=torch.uint8)
    pc = augment.randaugment_pc_params(B, SIZE, SIZE, g, "cpu")
    p1 = augment.weak_draws(B, SIZE, SIZE, g, "cpu")
    p2 = {mode: (augment.weak_draws if mode == "dual_weak" else augment.strong_params)(
        B, SIZE, SIZE, g, "cpu") for mode in augment.PAIR_MODES}

    def both(fn):
        on_card = fn(lambda t: t.to(dev))
        on_cpu = fn(lambda t: t)
        return [_rel_err(x, y) for x, y in zip(on_card, on_cpu)]

    def to(move, p):
        return {k: move(v) for k, v in p.items()}

    errs = {"randaugment_pc": both(lambda m: [augment.randaugment_pc_from_params(
        m(augment.planar_f32(imgs_cpu)), to(m, pc))])}
    for mode in augment.PAIR_MODES:
        errs[f"augment_pair {mode}"] = both(lambda m, mode=mode: augment.augment_pair_from_params(
            m(imgs_cpu), to(m, p1), to(m, p2[mode]), MEAN, STD, mode))
    ops = sorted(set(pc["op_idx"][pc["do"]].tolist()))
    print(f"phase slice_preaug: card vs CPU on the same draws, B={B} {SIZE} px, largest "
          f"difference over the largest magnitude: "
          + ", ".join(f"{k} {' '.join(f'{e:.3e}' for e in v)}" for k, v in errs.items())
          + f" (tol {VIEW_REL_TOL}; RandAugmentPC ops applied {ops})")
    if not all(e <= VIEW_REL_TOL for v in errs.values() for e in v):
        raise SystemExit(f"slice_preaug: card and CPU views disagree: {errs}")
    return launches


def phase_probe_convbn(card: str) -> dict:
    """The ported probe, 3 reps of 8 calls a candidate at each shape: each
    fused candidate launches once to warm up and 24 times timed."""
    from fedmlp_tpu_torch.tools import probe_fused_conv_bn as probe

    reps, iters = 3, 8
    reset_launch_counts()
    t0 = time.perf_counter()
    results = probe.main(["--reps", str(reps), "--iters", str(iters)])
    torch.cuda.synchronize()
    launches = read_launch_counts()
    times = {k: v for k, v in results.items() if k.endswith("_ms")}
    print(f"phase probe_convbn: {len(probe.SHAPES)} shapes in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    if len(times) != 4 * len(probe.SHAPES) or not all(
            math.isfinite(v) and v > 0 for v in times.values()):
        raise SystemExit(f"probe_convbn: missing or bad times {times}")
    per = len(probe.SHAPES) * (1 + reps * iters)
    check_launches("probe_convbn", launches,
                   {"conv1x1_bn_stats": per, "conv1x1_bn_act_2pass": per})
    return launches


def phase_slice_fednoro(dev, card: str) -> dict:
    """FedNoRo, 20 clients, warm-up 1, three rounds (the last evaluates):
    round 0 FedAvg; round 1 splits on round 0's losses and aggregates with
    DaAgg while every client still trains LA_KD; round 2 trains the clean
    clients on plain BCE and the noisy ones on LA_KD, and splits again."""
    from fedmlp_tpu_torch.config import FedNoRoConfig

    rounds = 3
    # one weak view a step (the frozen global model reads the same view);
    # the last round's evaluation normalizes its 64 test images in one chunk
    tr, launches = run_path(
        "slice_fednoro", dev, card,
        strong_config("fednoro", K, rounds,
                      fednoro=FedNoRoConfig(rounds_warmup=1, begin=0, end=2)), rounds,
        lambda tr: {"fused_warp_normalize": rounds * client_steps(tr),
                    "normalize_flip_cutout": 1})
    st = tr.server_state
    weights = getattr(tr, "daagg_weights", None)
    print(f"phase slice_fednoro: split on round 1's losses: clean {st['clean']} noisy "
          f"{st['noisy']}; DaAgg weights {None if weights is None else weights.tolist()}")
    if st["clean"] is None or sorted(st["clean"] + st["noisy"]) != list(range(K)):
        raise SystemExit(f"slice_fednoro: the split does not cover the {K} clients: {st}")
    if weights is None or not (all(math.isfinite(v) for v in weights)
                               and abs(float(weights.sum()) - 1.0) <= 1e-5):
        raise SystemExit(f"slice_fednoro: DaAgg did not run or its weights are bad: {weights}")
    return launches


def _slice_rscfed(dev, card: str) -> dict:
    """RSCFed through ``cli.main`` with ``--dw_backend pallas`` and a
    checkpoint each round: 2 rounds, then ``--resume`` from round 0's
    checkpoint, whose round 1 must repeat the first run's losses exactly
    (cuDNN held to deterministic algorithms for this path; the depthwise
    backward is the repo's own fixed-order kernels). The checkpoint's teacher,
    restored into a ``Trainer``, must differ from its global model."""
    import os
    import pickle
    import tempfile

    from fedmlp_tpu_torch import cli
    from fedmlp_tpu_torch.train import Trainer
    from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint

    path, rounds, n_train = "slice_rscfed", 2, K * 4 * B
    with tempfile.TemporaryDirectory() as out:
        argv = ["--exp", "RSCFed", "--dataset", "synthetic", "--model", "efficient_b0",
                "--n_clients", str(K), "--n_classes", str(N_CLASSES),
                "--image_size", str(SIZE), "--batch_size", str(B), "--p_pos", "0",
                "--base_lr", "3e-5", "--compute_dtype", "bfloat16",
                "--synthetic_train_size", str(n_train), "--synthetic_test_size", str(N_TEST),
                "--dw_backend", "pallas", "--rounds", str(rounds), "--checkpoint_every", "1",
                "--eval_every", "1000000", "--seed", "1037", "--output_dir", out,
                "--exp_tag", "rscfed", "--device", dev.type]
        metrics_path = os.path.join(out, "rscfed", "logs", "metrics.jsonl")
        ckpts = [os.path.join(out, "rscfed", "models", f"ckpt_{r}.pkl") for r in range(rounds)]

        def round_seconds() -> list:
            with open(ckpts[-1], "rb") as fh:
                return [h[3] for h in pickle.load(fh)["history"]]

        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            reset_launch_counts()
            cli.main(argv)
            torch.cuda.synchronize()
            first, seconds = _read_losses(metrics_path), round_seconds()
            cli.main(argv + ["--resume", ckpts[0]])
            torch.cuda.synchronize()
            launches = read_launch_counts()
            again, resumed = _read_losses(metrics_path), round_seconds()[-1]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        for rnd, secs in enumerate(seconds + [resumed]):
            print(f"phase {path}: round {min(rnd, rounds - 1)}"
                  f"{' (resumed)' if rnd == rounds else ''} {secs:.3f} s "
                  f"{n_train / secs:.1f} img/s dw_backend=pallas [{card}]")
        flat = [v for r in first.values() for v in r] + again[1]
        if sorted(first) != [0, 1] or not all(math.isfinite(v) for v in flat):
            raise SystemExit(f"{path}: missing or non-finite losses {first} {again}")
        print(f"phase {path}: round 1 losses {first[1]}, resumed {again[1]}")
        if again[1] != first[1]:
            raise SystemExit(f"{path}: the resumed round 1 differs: {first[1]} vs {again[1]}")

        t0 = time.perf_counter()
        tr = Trainer(cli.config_from_args(cli.args_parser(argv)), device=dev)
        load_checkpoint(ckpts[0], tr)
        teacher = tr._rscfed_teacher
        gap = [max(float((teacher[n][k].float() - v.float()).abs().max())
                   for n, v in tr.global_vars.items()) for k in range(K)]
        print(f"phase {path}: restored teacher against the global model, largest "
              f"|difference| a client {min(gap):.3e} to {max(gap):.3e} "
              f"({time.perf_counter() - t0:.2f} s)")
        if not all(math.isfinite(g) and g > 0 for g in gap):
            raise SystemExit(f"{path}: the restored teacher equals the global model: {gap}")
    # two views a step; the student's forward (view 1) gets a backward, the
    # teacher's (view 2) does not; the last round of each call evaluates
    steps = K * (4 * B // B)
    check_launches(path, launches, {
        "fused_warp_normalize": 2 * steps * (rounds + 1),
        "dw_dgrad": 16 * steps * (rounds + 1), "dw_wgrad": 16 * steps * (rounds + 1),
        "normalize_flip_cutout": 2})
    return launches


def phase_slice_baselines(dev, card: str) -> dict:
    """FedLSR, RSCFed, FedIRM, RoFL and ``centralized`` at the geometry of
    ``strong_config`` (EfficientNet-B0, 224 px, batch 32, 20 clients, 8
    classes, p_pos=0, bf16, 128 images a client); only the rounds are cut.
    Each a path of its own: its launch counts set to 0 just before its rounds
    and read just after; its last round evaluates (one
    ``normalize_flip_cutout`` chunk of the 64 test images)."""
    from fedmlp_tpu_torch.config import FedIRMConfig

    out = {}
    # FedLSR: two weak views a step
    _, out["slice_fedlsr"] = run_path(
        "slice_fedlsr", dev, card, strong_config("fedlsr", K, 1), 1,
        lambda tr: {"fused_warp_normalize": 2 * client_steps(tr),
                    "normalize_flip_cutout": 1})

    out["slice_rscfed"] = _slice_rscfed(dev, card)

    # FedIRM: a supervised round that reports the relation matrices, then a
    # relation round with the params-only EMA teacher
    tr, out["slice_fedirm"] = run_path(
        "slice_fedirm", dev, card,
        strong_config("fedirm", K, 2, fedirm=FedIRMConfig(rounds_sup=1)), 2,
        lambda tr: {"fused_warp_normalize": 2 * 2 * client_steps(tr),
                    "normalize_flip_cutout": 1})
    rel = tr.server_state["relation"]
    print(f"phase slice_fedirm: relation matrix diagonal {rel.diagonal().tolist()}, "
          f"|x - 0.5| up to {float(abs(rel - 0.5).max()):.4f}")
    if not (tr.server_state["ema_init"] and hasattr(tr, "_fedirm_teacher")):
        raise SystemExit("slice_fedirm: the relation round did not run")
    if not (math.isfinite(float(rel.sum())) and float(abs(rel - 0.5).max()) > 0):
        raise SystemExit(f"slice_fedirm: relation matrix not finite or still 0.5: {rel}")

    # RoFL: one weak view a step, plus the harvest of every client's table
    # (4B images a chunk) at the start of each round; round 0 builds the
    # centroids from the harvest, round 1 starts from f_G
    tr, out["slice_rofl"] = run_path(
        "slice_rofl", dev, card, strong_config("rofl", K, 2), 2,
        lambda tr: {"fused_warp_normalize": 2 * (client_steps(tr) + tr.n_clients * int(
            math.ceil(tr.fd.max_local / (4 * B)))), "normalize_flip_cutout": 1})
    st = tr.server_state
    if not (np.isfinite(st["f_G"]).all() and np.isfinite(st["pseudo"]).all()):
        raise SystemExit("slice_rofl: non-finite centroids or pseudo-labels")
    print(f"phase slice_rofl: f_G {st['f_G'].shape} norm {float(np.linalg.norm(st['f_G'])):.4f}, "
          f"pseudo positives {int(st['pseudo'].sum())}")

    # centralized: one client holding every image, every class active
    tr, out["slice_centralized"] = run_path(
        "slice_centralized", dev, card, strong_config("centralized", 1, 1), 1,
        lambda tr: {"fused_warp_normalize": client_steps(tr), "normalize_flip_cutout": 1})
    if tr.n_clients != 1 or not bool(tr.fd.active.all()) or tr.hidden.any():
        raise SystemExit("slice_centralized: not one client with every label")
    return out


def _read_losses(metrics_path: str) -> dict:
    """{round: [client losses]} from a ``metrics.jsonl``, later records of a
    (round, client) replacing earlier ones."""
    by_round: dict = {}
    with open(metrics_path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "/warm-up-loss/client" in rec["tag"]:
                client = int(rec["tag"].rsplit("client", 1)[1])
                by_round.setdefault(rec["step"], {})[client] = rec["value"]
    return {r: [v[c] for c in sorted(v)] for r, v in by_round.items()}


CLI_CLIENTS, CLI_ROUNDS = 4, 2


def cli_argv() -> list:
    """The CLI's arguments of ``cli`` and ``cli_torchrun`` but the output
    directory: FedAVG at the geometry of bench.py::_bench_fedavg (4 clients,
    EfficientNet-B0, 224 px, batch 32, 5 classes, p_pos=1, bf16, synthetic,
    128 images a client) with ``--dw_backend pallas``, 2 rounds, a
    checkpoint after each, the last round evaluated."""
    return ["--exp", "FedAVG", "--dataset", "synthetic", "--model", "efficient_b0",
            "--n_clients", str(CLI_CLIENTS), "--n_classes", "5",
            "--image_size", str(SIZE), "--batch_size", str(B), "--p_pos", "1",
            "--base_lr", "3e-5", "--compute_dtype", "bfloat16",
            "--synthetic_train_size", str(CLI_CLIENTS * 128),
            "--synthetic_test_size", str(N_TEST), "--dw_backend", "pallas",
            "--rounds", str(CLI_ROUNDS), "--checkpoint_every", "1",
            "--eval_every", "1000000", "--seed", "1037", "--exp_tag", "smoke"]


def phase_cli(dev, card: str) -> dict:
    """``fedmlp_tpu_torch.cli.main`` in-process on the card: FedAVG at the
    geometry of bench.py::_bench_fedavg (4 clients, EfficientNet-B0, 224 px,
    batch 32, 5 classes, p_pos=1, bf16, synthetic, 128 images a client) with
    ``--dw_backend pallas``, 2 rounds, a checkpoint after each; then a
    second call that resumes from round 0's checkpoint and runs round 1
    again."""
    import os
    import tempfile

    from fedmlp_tpu_torch import cli

    n_clients, rounds = CLI_CLIENTS, CLI_ROUNDS
    with tempfile.TemporaryDirectory() as out:
        argv = cli_argv() + ["--output_dir", out]
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launch_counts()
        metrics_path = os.path.join(out, "smoke", "logs", "metrics.jsonl")
        ckpts = [os.path.join(out, "smoke", "models", f"ckpt_{r}.pkl")
                 for r in range(rounds)]
        for f in [metrics_path] + ckpts:
            if not os.path.exists(f):
                raise SystemExit(f"cli: {f} was not written")
        first = _read_losses(metrics_path)
        print(f"phase cli: {rounds} FedAVG rounds in {secs:.2f} s (set-up and final "
              f"evaluation included) losses {first} [{card}]")
        steps = n_clients * (128 // B) * rounds
        # the last round evaluates: 64 test images, one chunk of the test
        # transform
        check_launches("cli", launches, {
            "fused_warp_normalize": steps, "dw_dgrad": 16 * steps,
            "dw_wgrad": 16 * steps, "normalize_flip_cutout": 1})

        cli.main(argv + ["--resume", ckpts[0]])
        torch.cuda.synchronize()
        again = _read_losses(metrics_path)
    flat = [v for r in first.values() for v in r] + again[1]
    if sorted(first) != [0, 1] or not all(math.isfinite(v) for v in flat):
        raise SystemExit(f"cli: missing or non-finite losses {first} {again}")
    # tolerance: the resumed round starts from the saved weights, host RNG
    # and generator state, so plans and augmentation draws are equal; cuDNN's
    # backward of the 1x1 convolutions may sum in another order from run to
    # run, which bf16 activations can carry into the 4th digit of a loss
    diff = max(abs(a - b) / abs(a) for a, b in zip(first[1], again[1]))
    print(f"phase cli: resumed round 1 losses {again[1]}, max relative "
          f"difference to the first run {diff:.3e} (tol 1e-3)")
    if not diff <= 1e-3:
        raise SystemExit(f"cli: resumed round differs: {first[1]} vs {again[1]}")
    return launches


# seconds the torchrun of cli_torchrun, and the launch beside it, may take
CLI_TORCHRUN_TIMEOUT_S = 400


def cli_child(counts_dir: str, argv: list) -> int:
    """One process of ``cli_torchrun``'s ``torchrun`` (``chip_smoke.py
    --cli-child DIR ARGV...``): cuDNN deterministic, the launch counts set
    to 0, ``fedmlp_tpu_torch.cli.main(ARGV)`` (which starts the group from
    the launcher's environment, ``init_from_env``), then this rank's counts
    written to ``DIR/rank{RANK}.json``."""
    import os

    from fedmlp_tpu_torch import cli

    torch.backends.cudnn.deterministic = True
    reset_launch_counts()
    cli.main(argv)
    torch.cuda.synchronize()
    with open(os.path.join(counts_dir, f"rank{os.environ['RANK']}.json"), "w") as fh:
        json.dump(read_launch_counts(), fh)
    return 0


def cli_launched_rank(argv: list, root: str) -> None:
    """A rank of the group that ``launch`` starts (its ``FileStore``): cuDNN
    deterministic, ``cli.main(argv)`` writing under ``root/rank{rank}``."""
    import os

    from fedmlp_tpu_torch import cli
    from fedmlp_tpu_torch.parallel.mesh import process_rank

    torch.backends.cudnn.deterministic = True
    cli.main(argv + ["--output_dir", os.path.join(root, f"rank{process_rank()}")])


def _ckpt_digest(path: str) -> str:
    """``_digest`` of a checkpoint's global variables."""
    import pickle

    with open(path, "rb") as fh:
        packed = pickle.load(fh)["global_vars"]
    return _digest({n: v["__tensor__"] for n, v in packed.items()})


def phase_cli_torchrun(dev, card: str) -> dict:
    """The CLI started by ``torchrun`` on 2 processes sharing the card:
    ``python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py --cli-child ...`` runs ``cli.main`` on ``cli``'s
    arguments plus ``--pre_augment 256`` in each (``cli_child``), the group
    started from the environment (``env://``). Beside it, the same arguments
    in a group that ``launch`` starts. Gates: exit 0; rank 0 printed the
    mesh line with gloo; one output tree, written by rank 0 alone (each
    checkpoint, metric record and log line once, rank 1 wrote no file);
    the final checkpoint's global variables equal the launched group's bit
    for bit (both with cuDNN deterministic); each rank's launches those its
    two clients imply."""
    import os
    import signal
    import tempfile

    from fedmlp_tpu_torch.parallel.mesh import launch

    argv = cli_argv() + ["--pre_augment", str(PREAUG_CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:
        out, counts = os.path.join(tmp, "torchrun"), os.path.join(tmp, "counts")
        os.makedirs(counts)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(MESH_RANKS), os.path.abspath(__file__),
               "--cli-child", counts] + argv + ["--output_dir", out]
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "stdout"), "w") as so, \
                open(os.path.join(tmp, "stderr"), "w") as se:
            proc = subprocess.Popen(cmd, stdout=so, stderr=se, start_new_session=True)
            try:
                launch(cli_launched_rank, MESH_RANKS, (argv, os.path.join(tmp, "launched")),
                       device="cuda", timeout_s=CLI_TORCHRUN_TIMEOUT_S)
                rc = proc.wait(timeout=max(1.0, CLI_TORCHRUN_TIMEOUT_S
                                           - (time.perf_counter() - t0)))
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        secs = time.perf_counter() - t0
        with open(os.path.join(tmp, "stdout")) as fh:
            stdout = fh.read()
        with open(os.path.join(tmp, "stderr")) as fh:
            stderr = fh.read()
        print(f"phase cli_torchrun: torchrun exit {rc}, {secs:.1f} s with the launched "
              f"group beside it [{card}]")
        if rc != 0:
            raise SystemExit(f"cli_torchrun: torchrun exited {rc}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
        mesh_lines = [line for line in stdout.splitlines() if line.startswith("mesh: ")]
        tree = os.path.join(out, "smoke")
        files = sorted(os.path.relpath(os.path.join(d, f), tree)
                       for d, _, fs in os.walk(tree) for f in fs)
        with open(os.path.join(tree, "logs", "metrics.jsonl")) as fh:
            keys = [(r["tag"], r["step"]) for r in map(json.loads, fh)]
        with open(os.path.join(tree, "logs", "logs.txt")) as fh:
            engine_lines = sum("engine: per-client loop" in line for line in fh)
        ckpts = [f for f in files if f.startswith("models/")]
        one_writer = (ckpts == [f"models/ckpt_{r}.pkl" for r in range(CLI_ROUNDS)]
                      and sum("tfevents" in f for f in files) <= 1
                      and len(keys) == len(set(keys)) and engine_lines == 1)
        final = f"ckpt_{CLI_ROUNDS - 1}.pkl"
        got = _ckpt_digest(os.path.join(tree, "models", final))
        want = _ckpt_digest(os.path.join(tmp, "launched", "rank0", "smoke", "models", final))
        launched_rank1 = os.path.exists(os.path.join(tmp, "launched", "rank1"))
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(counts, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    print(f"phase cli_torchrun: mesh line {mesh_lines}; one output tree {files}, "
          f"{len(keys)} metric records, each once, one writer {one_writer}; the launched "
          f"group's rank 1 wrote nothing {not launched_rank1} [{card}]")
    print(f"phase cli_torchrun: final checkpoint global variables {got[:16]}, the launched "
          f"group's {want[:16]}: equal bits {got == want} [{card}]")
    if mesh_lines != [f"mesh: {MESH_RANKS} processes, backend gloo (gloo on the CPU or "
                      "when ranks share a card, NCCL with a card a rank)"]:
        raise SystemExit(f"cli_torchrun: mesh lines {mesh_lines}")
    if not one_writer or launched_rank1:
        raise SystemExit(f"cli_torchrun: output written by more than rank 0: {files}")
    if got != want:
        raise SystemExit("cli_torchrun: the torchrun run's final global variables differ "
                         "from the launched group's")
    # a rank's 2 clients: 128 images each, so its 256 view positions a
    # round are one chunk of the weak view; 16 depthwise layers a step;
    # the last round's evaluation, one normalize chunk a rank
    steps = CLI_CLIENTS // MESH_RANKS * (128 // B) * CLI_ROUNDS
    for r, got_r in enumerate(ranks):
        check_launches(f"cli_torchrun rank {r}", got_r, {
            "fused_warp_normalize": CLI_ROUNDS, "dw_dgrad": 16 * steps,
            "dw_wgrad": 16 * steps, "normalize_flip_cutout": 1})
    return {n: sum(c[n] for c in ranks) for n in ranks[0]}


_KERNEL_KINDS = (
    ("warp", ("fused_warp",)),
    ("dw_kernels", ("dw_dgrad", "dw_wgrad")),
    ("conv", ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "cutlass")),
    ("batch_norm", ("batch_norm", "bn_", "batchnorm")),
    ("adam", ("multi_tensor", "adam")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def layer_host_us(dev, backend: str, iters: int = 300) -> float:
    """Host microseconds of one depthwise layer's forward and backward under
    bf16 autocast, at a size whose kernels take next to no device time
    (B=2, C=32, 14x14, k=3): the per-layer cost the host pays to issue the
    work, which is what a host-bound step feels."""
    from fedmlp_tpu_torch.models.layers import same_pad, same_pads
    from fedmlp_tpu_torch.ops.depthwise import DepthwisePallas

    C, H, k = 32, 14, 3
    if backend == "pallas":
        layer = DepthwisePallas(C, k, 1).to(dev)
        pads = (same_pads(H, k, 1), same_pads(H, k, 1))
        torch.nn.init.normal_(layer.weight)
        run = lambda x: layer(x, pads)  # noqa: E731
    else:
        layer = torch.nn.Conv2d(C, C, k, 1, groups=C, bias=False).to(dev)
        run = lambda x: layer(same_pad(x, k, 1))  # noqa: E731
    x = torch.randn((2, C, H, H), device=dev, requires_grad=True)

    def step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = run(x)
        y.sum().backward()

    for _ in range(20):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def profiled(fn) -> tuple:
    """Run ``fn()`` under ``torch.profiler`` → (wall seconds, device
    microseconds by kernel name, device operations by kernel name)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name, counts = defaultdict(float), defaultdict(int)
    for e in prof.events():
        # a user annotation (e.g. Optimizer.step) spans kernels that are
        # counted on their own already
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] += e.time_range.elapsed_us()
            counts[e.name] += 1
    return wall_s, by_name, counts


def phase_profile_strong(dev, card: str) -> None:
    """What the strong view costs a FixMatch step. First the views alone at
    B=32, 224 px, 8 calls each under the profiler: the weak view ('fused'),
    the strong view with shear passes and with bilinear gathers: device ms
    and device operations a call, and which kernels carry them. Then one
    steady FixMatch round of 2 clients x 4 steps: unprofiled wall time,
    device busy share and operations a step, beside the same trainer with
    both views normalize-only (what remains is the model's step)."""
    from fedmlp_tpu_torch.ops import augment
    from fedmlp_tpu_torch.train import Trainer

    g = torch.Generator(device=dev)
    g.manual_seed(1037)
    imgs = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    calls = 8
    views = {"weak fused": augment.pick_weak_backend("fused"),
             "strong shear": augment.pick_strong_backend("fused"),
             "strong gather": augment.pick_strong_backend("gather")}
    for name, view in views.items():
        for _ in range(3):
            view(imgs, g, mean, std)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            view(imgs, g, mean, std)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        _, by_name, counts = profiled(lambda view=view: [view(imgs, g, mean, std)
                                                         for _ in range(calls)])
        n = sum(counts.values())
        busy_us = sum(by_name.values())
        tag = f"phase profile_strong [{name}]:"
        print(f"{tag} B={B} {SIZE}px: {busy_us / calls / 1e3:.3f} device ms a call, "
              f"{n / calls:.0f} device ops a call, {plain_s / calls * 1e3:.3f} ms a call "
              f"unprofiled wall [{card}]")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"{tag} kernel {us / calls / 1e3:8.3f} ms a call {us / busy_us:.3f} "
                  f"{kname[:100]}")
    steps = 2 * 4
    for backend in ("auto", "normonly"):
        cfg = strong_config("fixmatch", 2, 10**6)  # no round evaluates
        cfg = cfg.replace(data=type(cfg.data)(**{**cfg.data.__dict__,
                                                 "augment_backend": backend}))
        tr = Trainer(cfg, device=dev)
        tr.run_round(0)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        plain = []
        for _ in range(4):
            t0 = time.perf_counter()
            tr.run_round(0)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
        wall_s, by_name, counts = profiled(lambda tr=tr: tr.run_round(0))
        n = sum(counts.values())
        busy_us = sum(by_name.values())
        for kname, us in by_name.items():
            if any(k in kname for k in ("hshift", "fused_warp", "bce_", "flip_cutout")):
                print(f"phase profile_strong [fixmatch round, views {backend}]: kernel "
                      f"{kname[:60]} {counts[kname]} launches, {us / counts[kname]:.2f} us "
                      f"each, {us / 1e3 / steps:.3f} ms a step")
        print(f"phase profile_strong [fixmatch round, views {backend}]: 2 clients x 4 "
              f"steps: unprofiled {' '.join(f'{t:.3f}' for t in plain)} s (median "
              f"{statistics.median(plain) / steps * 1e3:.1f} ms a step), device busy "
              f"{busy_us / 1e3 / steps:.2f} ms a step = {busy_us / 1e6 / wall_s:.3f} of "
              f"the profiled wall, {n / steps:.0f} device ops a step [{card}]")


def phase_profile(dev, card: str) -> None:
    """Where a stage-1 round's time goes, with the default depthwise backend
    and with ``dw_backend='pallas'``: one steady stage-1 round of a 2-client
    trainer with the flagship's per-client geometry (B=32, 128 images a
    client, 224 px, bf16); the flagship round repeats this client loop 20
    times. First the unprofiled round's wall time for each backend, four
    times in the order conv, pallas, pallas, conv (the host's clock is
    noisy: the spread is part of the reading); then ``torch.profiler`` over
    one round of each: the device's busy share and device time by kernel
    kind and by kernel."""
    from collections import defaultdict

    from fedmlp_tpu_torch.train import Trainer

    steps = 2 * 4
    trainers = {}
    for backend in ("conv", "pallas"):
        tr = Trainer(flagship_config(2, 2 * 4 * B, dw_backend=backend), device=dev)
        tr.run_round(0)  # warm-up: cuDNN algorithm choice, allocator
        trainers[backend] = tr
    torch.cuda.synchronize()
    plain_s = defaultdict(list)
    for backend in ("conv", "pallas", "pallas", "conv") * 4:
        t0 = time.perf_counter()
        trainers[backend].run_round(0)
        torch.cuda.synchronize()
        plain_s[backend].append(time.perf_counter() - t0)
    for backend, tr in trainers.items():
        wall_s, by_name, counts = profiled(lambda tr=tr: tr.run_round(0))
        n_kernels = sum(counts.values())
        busy_us = sum(by_name.values())
        by_kind = defaultdict(float)
        for name, us in by_name.items():
            low = name.lower()
            kind = next((k for k, keys in _KERNEL_KINDS if any(x in low for x in keys)),
                        "other")
            by_kind[kind] += us
        tag = f"phase profile [{backend}]:"
        unprofiled = plain_s[backend]
        print(f"{tag} stage-1 round, 2 clients x 4 steps: unprofiled "
              f"{' '.join(f'{t:.3f}' for t in unprofiled)} s (median "
              f"{statistics.median(unprofiled):.3f} s, "
              f"{statistics.median(unprofiled) / steps * 1e3:.1f} ms a step), "
              f"{wall_s:.3f} s profiled, device busy {busy_us / 1e6:.3f} s = "
              f"{busy_us / 1e6 / wall_s:.3f} of the profiled wall, "
              f"{n_kernels / steps:.0f} device ops a step [{card}]")
        for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"{tag} kind {kind:12s} {us / 1e3:9.2f} ms "
                  f"{us / busy_us:.3f} of device time")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
            print(f"{tag} kernel {us / 1e3:9.2f} ms {us / busy_us:.3f} {name[:110]}")
    host = defaultdict(list)
    for backend in ("conv", "pallas", "pallas", "conv"):
        host[backend].append(layer_host_us(dev, backend))
    print("phase profile: host us of one small depthwise layer's forward + backward "
          + ", ".join(f"{b}: {' '.join(f'{u:.1f}' for u in us)}" for b, us in host.items())
          + f" [{card}]")


# kernels each path must launch at least once
_PATH_KERNELS = {
    "slice": ("fused_warp_normalize",),
    "slice_dw": ("fused_warp_normalize", "dw_dgrad", "dw_wgrad"),
    "cli": ("fused_warp_normalize", "dw_dgrad", "dw_wgrad",
            "normalize_flip_cutout"),
    "slice_strong": ("fused_warp_normalize", "hshift_rows",
                     "bce_with_logits_masked_sum", "bce_with_logits_masked_grad",
                     "normalize_flip_cutout"),
    "slice_cbafed": ("fused_warp_normalize", "normalize_flip_cutout"),
    "probe_convbn": ("conv1x1_bn_stats", "conv1x1_bn_act_2pass"),
    "slice_fednoro": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_fedlsr": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_rscfed": ("fused_warp_normalize", "dw_dgrad", "dw_wgrad",
                     "normalize_flip_cutout"),
    "slice_fedirm": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_rofl": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_centralized": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_resnet18": ("fused_warp_normalize", "normalize_flip_cutout"),
    "models_zoo": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_lockstep": ("fused_warp_normalize",),
    "slice_stacked": ("fused_warp_normalize",),
    "slice_views": ("fused_warp_normalize", "dw_dgrad", "dw_wgrad"),
    "slice_preaug": ("fused_warp_normalize", "hshift_rows", "bce_with_logits_masked_sum",
                     "bce_with_logits_masked_grad", "normalize_flip_cutout"),
    "slice_stream": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_mesh": ("fused_warp_normalize", "normalize_flip_cutout"),
    "slice_mesh_preaug": ("fused_warp_normalize", "hshift_rows",
                          "bce_with_logits_masked_sum", "bce_with_logits_masked_grad",
                          "normalize_flip_cutout"),
    "cli_torchrun": ("fused_warp_normalize", "dw_dgrad", "dw_wgrad",
                     "normalize_flip_cutout"),
    **{path: ("fused_warp_normalize",) for path, _ in KNOBS},
}


def phase_time_stream(dev, card: str) -> None:
    """Host streaming, A against B in one call: six flagship trainers over
    one packed shard, two each of the table on the card, streamed at once
    (W=0) and streamed in windows of ``STREAM_WINDOW``, their rounds run in
    turns, in the order A B C C B A (round r of each before round r+1 of
    any), so that a trainer's place in the turn falls on every variant
    alike: 2 stage-1 rounds (the second harvests) and a stage-2 round.
    Seconds, images/s and, when streamed, the seconds the host spent in the
    loader's gathers and waits (the program's spans, host clock) of each
    round, and each round's harvests (their spans on the device's clock);
    then each variant's mean. Peak memory is not read: the six trainers share the
    card."""
    import tempfile

    from fedmlp_tpu_torch.train import Trainer
    from fedmlp_tpu_torch.utils import profiling as P

    with tempfile.TemporaryDirectory() as root:
        base = flagship_config(K, N)
        datasets = packed_flagship("time_stream", root, base.seed, N)
        variants = (("resident", base), ("stream W=0", streamed(base, root, 0)),
                    (f"stream W={STREAM_WINDOW}", streamed(base, root, STREAM_WINDOW)))
        runs = [(name, Trainer(cfg, train_ds=datasets[0], test_ds=datasets[1], device=dev))
                for name, cfg in variants + variants[::-1]]  # in A B C C B A order
        secs = {name: [] for name, _ in variants}
        for rnd in range(3):
            line = []
            for name, tr in runs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = [tr.run_round(rnd).spans]
                torch.cuda.synchronize()
                t = time.perf_counter() - t0
                secs[name].append(t)
                read = span_total(rec, P.LOADER_WAIT)[1] + span_total(rec, P.LOADER_GATHER)[1]
                line.append(f"{name} {t:.3f} s ({N / t:.1f} img/s, harvest "
                            f"{span_total(rec, P.HARVEST, 'device')[1]:.3f} s, loader "
                            f"{read:.3f} s)")
            print(f"phase time_stream round {rnd}: {'; '.join(line)} [{card}]")
        for name, t in secs.items():
            means = [statistics.mean(t[2 * r:2 * r + 2]) for r in range(3)]
            rel = [m / statistics.mean(secs["resident"][2 * r:2 * r + 2])
                   for r, m in enumerate(means)]
            print(f"phase time_stream: {name} mean of 2, rounds 0-2 "
                  f"{' '.join(f'{m:.3f}' for m in means)} s, "
                  f"{' '.join(f'{x:.3f}' for x in rel)} of resident [{card}]")
        del runs
        torch.cuda.empty_cache()


def phase_time_views(dev, card: str) -> None:
    """Where the views are made, A against B in one call: trainers that
    differ in one knob, their rounds run in turns (the same round index on
    each before the next), so host noise falls on all of them alike. The
    flagship (``dw_backend='pallas'``, 2 stage-1 + 2 stage-2 rounds):
    views in the step, two forwards a stage-1 step; ``view_concat='on'``;
    and ``view_concat='on'`` with ``hoist_augment=1`` (stage 2 hoisted).
    FixMatch at slice_strong's geometry, 3 rounds: views in the step and
    ``pre_augment=256``. Seconds and peak memory of each round."""
    from fedmlp_tpu_torch.train import Trainer

    runs = {
        "flagship": ({"in-step": {}, "view_concat": {"view_concat": "on"},
                      "view_concat+hoist": {"view_concat": "on", "hoist_augment": 1}},
                     lambda kw: flagship_config(K, N, 2, "pallas", **kw), 4),
        "fixmatch": ({"in-step": {}, "pre_augment=256": {"pre_augment": 256}},
                     lambda kw: strong_config("fixmatch", K, 10**6, **kw), 3),
    }
    for family, (variants, make_cfg, n_rounds) in runs.items():
        trainers = {name: Trainer(make_cfg(kw), device=dev) for name, kw in variants.items()}
        for rnd in range(n_rounds):
            line = []
            for name, tr in trainers.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                tr.run_round(rnd)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                line.append(f"{name} {secs:.3f} s ({N / secs:.1f} img/s, "
                            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            print(f"phase time_views [{family}] round {rnd}: {'; '.join(line)} [{card}]")
        del trainers
        torch.cuda.empty_cache()


def phase_profile_convbn(dev, card: str) -> None:
    """How the conv-BN wrappers' device time divides between their launches
    (``conv1x1_bn_stats``: the product pass and the finalize;
    ``conv1x1_bn_act_2pass``: the statistics pass, the finalize with the
    fold, the normalize pass): device µs a launch under ``torch.profiler``,
    5 calls of each wrapper at each of the probe's bf16 shapes, every call
    from a flushed L2."""
    from fedmlp_tpu_torch.ops import fused_conv_bn as CB
    from fedmlp_tpu_torch.tools.probe_fused_conv_bn import SHAPES

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for M, Ci, Co in SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(M)
        x = torch.randn((M, Ci), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((Ci, Co), generator=g, device=dev).to(torch.bfloat16)
        scale = torch.rand((Co,), generator=g, device=dev) + 0.5
        bias = torch.randn((Co,), generator=g, device=dev)
        fns = (lambda: CB.conv1x1_bn_stats(x, w),
               lambda: CB.conv1x1_bn_act_2pass(x, w, scale, bias))
        for fn in fns:  # the launch plans, outside the profile
            fn()

        def run():
            for _ in range(5):
                for fn in fns:
                    flush.zero_()
                    fn()

        _, by_name, counts = profiled(run)
        parts = []
        for name, us in by_name.items():
            m = re.search(r"((?:conv1x1|stats_finalize)\w*)<([^<>()]*)>", name)
            if m:
                parts.append(f"{m.group(1)}<{m.group(2)}>={us / counts[name]:.2f}"
                             f"x{counts[name]}")
        print(f"phase profile_convbn: [{M}, {Ci}]x[{Ci}, {Co}] bf16 device us a launch, "
              f"flushed L2: {' '.join(sorted(parts))} [{card}]")


def main(argv=None) -> int:
    import fedmlp_tpu_torch  # noqa: F401  (fails outside a checkout)

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-child"]:  # a process of cli_torchrun's torchrun
        return cli_child(argv[1], argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernel,slice,slice_mesh,slice_lockstep,"
                                        "slice_stacked,slice_dw,cli,cli_torchrun,"
                                        "slice_strong,"
                                        "probe_convbn,slice_fednoro,slice_baselines,"
                                        "slice_resnet18,models_zoo,slice_views,"
                                        "slice_preaug,slice_knobs,slice_stream",
                    help="comma list of build,kernel,slice,slice_mesh,slice_lockstep,"
                         "slice_stacked,"
                         "slice_dw,cli,cli_torchrun,slice_strong,probe_convbn,"
                         "slice_fednoro,"
                         "slice_baselines,slice_resnet18,models_zoo,slice_views,"
                         "slice_preaug,slice_knobs,slice_stream,profile,profile_strong,"
                         "profile_convbn,time_b5b6,time_views,time_knobs,time_stream")
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
        kernels.append(phase_kernel_warp(dev))
        kernels.append(phase_kernel_hshift(dev))
        kernels.extend(phase_kernel_dw(dev))
        kernels.append(phase_kernel_preproc(dev))
        kernels.extend(phase_kernel_bce(dev))
        kernels.extend(phase_kernel_conv_bn(dev))
    by_path = {}
    if "slice" in phases:
        by_path["slice"] = phase_slice(dev, card)
    if "slice_mesh" in phases:
        by_path.update(phase_slice_mesh(dev, card))
    if "slice_lockstep" in phases:
        by_path["slice_lockstep"] = phase_slice_lockstep(dev, card)
    if "slice_stacked" in phases:
        by_path["slice_stacked"] = phase_slice_stacked(dev, card)
    if "slice_dw" in phases:
        by_path["slice_dw"] = phase_slice_dw(dev, card)
    if "cli" in phases:
        by_path["cli"] = phase_cli(dev, card)
    if "cli_torchrun" in phases:
        by_path["cli_torchrun"] = phase_cli_torchrun(dev, card)
    if "slice_strong" in phases:
        by_path.update(phase_slice_strong(dev, card))
    if "probe_convbn" in phases:
        by_path["probe_convbn"] = phase_probe_convbn(card)
    if "slice_fednoro" in phases:
        by_path["slice_fednoro"] = phase_slice_fednoro(dev, card)
    if "slice_baselines" in phases:
        by_path.update(phase_slice_baselines(dev, card))
    if "slice_resnet18" in phases:
        by_path["slice_resnet18"] = phase_slice_resnet18(dev, card)
    if "models_zoo" in phases:
        by_path["models_zoo"] = phase_models_zoo(dev, card)
    if "slice_views" in phases:
        by_path["slice_views"] = phase_slice_views(dev, card)
    if "slice_preaug" in phases:
        by_path["slice_preaug"] = phase_slice_preaug(dev, card)
    if "slice_knobs" in phases:
        by_path.update(phase_slice_knobs(dev, card))
    if "slice_stream" in phases:
        by_path["slice_stream"] = phase_slice_stream(dev, card)
    for path, launches in by_path.items():
        for name in _PATH_KERNELS[path]:
            if not launches[name]:
                raise SystemExit(f"{name} never launched on the {path} path")
    if by_path:
        for k in kernels:
            k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
            k["launches"] = sum(k["launches_by_path"].values())
    if "profile" in phases:
        phase_profile(dev, card)
    if "profile_strong" in phases:
        phase_profile_strong(dev, card)
    if "profile_convbn" in phases:
        phase_profile_convbn(dev, card)
    if "time_b5b6" in phases:
        phase_time_b5b6(dev, card)
    if "time_views" in phases:
        phase_time_views(dev, card)
    if "time_knobs" in phases:
        phase_time_knobs(dev, card)
    if "time_stream" in phases:
        phase_time_stream(dev, card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
