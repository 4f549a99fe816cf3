"""The weak view in plain float32: RandomAffine(±10°, ±2% translate),
RandomHorizontalFlip and Normalize (the FedMLP reference's weak transform),
as the program defines it: the affine map factored into three axis-aligned
shears (horizontal, vertical, horizontal), each a per-line two-tap lerp with
zero fill, the flip folded in as affine(−θ, −tx, ty) of the flipped image.

The draw is the program's: one uniform [4, B] from the generator per view,
(θ, tx, ty, flip) = (20u₀ − 10 degrees, (0.04u₁ − 0.02)·W, (0.04u₂ − 0.02)·H,
u₃ < ½).
"""

from __future__ import annotations

import math

import torch

DEGREES, TRANSLATE = 10.0, 0.02


def draw(B: int, H: int, W: int, generator: torch.Generator, device) -> tuple:
    u = torch.rand((4, B), generator=generator, device=device, dtype=torch.float32)
    ang = u[0] * (2.0 * DEGREES) - DEGREES
    tx = (u[1] * (2.0 * TRANSLATE) - TRANSLATE) * W
    ty = (u[2] * (2.0 * TRANSLATE) - TRANSLATE) * H
    return ang, tx, ty, u[3] < 0.5


def shear_params(theta, tx, ty, H: int, W: int) -> torch.Tensor:
    """[B, 3, 3]: (slope, offset, center) of the three passes whose
    composition is the inverse of rotation θ about the center, then (tx, ty)."""
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    sin, cos = torch.sin(theta), torch.cos(theta)
    alpha, beta = -torch.tan(theta / 2.0), sin
    c = cx - cos * cx + sin * cy + (cos * -tx + (-sin) * -ty)
    f = cy - sin * cx - cos * cy + (sin * -tx + cos * -ty)
    tau = (c - alpha * f) / 2.0 + alpha * cy
    t2 = f + alpha * beta * cy + beta * cx - beta * tau
    cyt, cxt = torch.full_like(alpha, cy), torch.full_like(alpha, cx)
    return torch.stack([torch.stack([alpha, tau, cyt], -1), torch.stack([beta, t2, cxt], -1),
                        torch.stack([alpha, tau, cyt], -1)], -2)


def shift_rows(x, p):
    """Row y of each image [B, C, H, W] sampled at x + s(y), s(y) =
    slope·(y − center) + offset, two-tap lerp, zero outside."""
    B, C, H, W = x.shape
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    s = p[:, 0:1] * (ys[None, :] - p[:, 2:3]) + p[:, 1:2]
    k = torch.floor(s)
    frac = (s - k)[:, None, :, None]
    lo = k.clamp(-(W + 1), W + 1).long()[:, :, None] + torch.arange(W, device=x.device)

    def tap(idx):
        inside = (idx >= 0) & (idx < W)
        g = torch.gather(x, 3, idx.clamp(0, W - 1)[:, None].expand(B, C, H, W))
        return torch.where(inside[:, None], g, torch.zeros((), device=x.device))

    return (1.0 - frac) * tap(lo) + frac * tap(lo + 1)


def apply(images_u8, ang, tx, ty, flip, mean, std):
    """u8 NHWC [B, S, S, 3] → normalized f32 NCHW."""
    H, W = images_u8.shape[1], images_u8.shape[2]
    ang = torch.where(flip, -ang, ang)
    tx = torch.where(flip, -tx, tx)
    p = shear_params(ang * (math.pi / 180.0), tx, ty, H, W)
    x = images_u8.permute(0, 3, 1, 2).to(torch.float32)
    x = torch.where(flip[:, None, None, None], x.flip(-1), x)
    x = shift_rows(x, p[:, 0])
    x = shift_rows(x.transpose(2, 3), p[:, 1]).transpose(2, 3)
    x = shift_rows(x, p[:, 2])
    m = torch.tensor([v * 255.0 for v in mean], dtype=torch.float32, device=x.device)
    s = torch.tensor([v * 255.0 for v in std], dtype=torch.float32, device=x.device)
    return (x - m[None, :, None, None]) / s[None, :, None, None]


def weak_view(images_u8, generator, mean, std):
    B, H, W, _ = images_u8.shape
    return apply(images_u8, *draw(B, H, W, generator, images_u8.device), mean, std)
