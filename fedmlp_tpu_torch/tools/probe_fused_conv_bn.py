"""A/B the fused 1×1-conv + batch-norm kernels against the unfused chain on
the card (port of ``tools/probe_fused_conv_bn.py``).

    python -m fedmlp_tpu_torch.tools.probe_fused_conv_bn [--reps 7] [--iters 24]

At EfficientNet-B0's pointwise shapes of the bench round (B=32, 224 px:
block1_0 expand [32·112·112, 16]·[16, 96], block2 expand [32·56·56,
24]·[24, 144], block4 expand [32·14·14, 80]·[80, 480]) in bf16, four
candidates run interleaved rep by rep, so that drift on the card hits them
alike:

* ``unfused``      — ``torch.matmul``, then the f32 channel sum and sum of
  squares of its bf16 output (the JAX probe's ``xla_pair``);
* ``fused``        — ``conv1x1_bn_stats``;
* ``unfusedfull``  — matmul → batch norm with those batch statistics →
  swish (``xla_full``);
* ``fused2p``      — ``conv1x1_bn_act_2pass``.

Each rep times ``iters`` calls of a candidate between two CUDA events; a
candidate's number is the median over reps of the mean milliseconds a
call. One JSON line a shape (keys ``{tag}_{candidate}_ms``, as the JAX
probe's ``{tag}_xla_ms``, ``_fused_ms``, ``_xlafull_ms``, ``_fused2p_ms``),
then all results. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from fedmlp_tpu_torch import resolve_device
from fedmlp_tpu_torch.ops.fused_conv_bn import conv1x1_bn_act_2pass, conv1x1_bn_stats

SHAPES = ((32 * 112 * 112, 16, 96), (32 * 56 * 56, 24, 144), (32 * 14 * 14, 80, 480))
CANDIDATES = ("unfused", "fused", "unfusedfull", "fused2p")


def timeit_interleaved(fns, reps: int, iters: int) -> list:
    """Median over ``reps`` of each candidate's mean ms a call; within a rep
    the candidates run in turn, ``iters`` calls each between CUDA events."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b) / iters)
    return [statistics.median(t) for t in times]


def candidates(x, w, scale, bias) -> tuple:
    def unfused():
        yf = torch.matmul(x, w).float()
        return yf.sum(0), (yf * yf).sum(0)

    def fused():
        return conv1x1_bn_stats(x, w)

    def unfusedfull():
        yf = torch.matmul(x, w).float()
        m = yf.mean(0)
        v = torch.clamp((yf * yf).mean(0) - m * m, min=0.0)
        z = (yf - m) * torch.rsqrt(v + 1e-3) * scale + bias
        return (z * torch.sigmoid(z)).to(x.dtype)

    def fused2p():
        return conv1x1_bn_act_2pass(x, w, scale, bias)

    return unfused, fused, unfusedfull, fused2p


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args(argv)
    dev = resolve_device()
    if dev.type != "cuda":
        raise RuntimeError("the probe times kernels on a card")
    results = {"device": torch.cuda.get_device_name(dev), "reps": args.reps,
               "iters": args.iters}
    rs = np.random.RandomState(0)
    for M, Ci, Co in SHAPES:
        x = torch.as_tensor(rs.randn(M, Ci), dtype=torch.bfloat16, device=dev)
        w = torch.as_tensor(rs.randn(Ci, Co), dtype=torch.bfloat16, device=dev)
        scale = torch.as_tensor(rs.rand(Co) + 0.5, dtype=torch.float32, device=dev)
        bias = torch.as_tensor(rs.randn(Co), dtype=torch.float32, device=dev)
        tag = f"M{M}_{Ci}to{Co}"
        ms = timeit_interleaved(candidates(x, w, scale, bias), args.reps, args.iters)
        for name, t in zip(CANDIDATES, ms):
            results[f"{tag}_{name}_ms"] = t
        print(json.dumps({k: v for k, v in results.items() if tag in k}), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
