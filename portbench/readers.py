"""Arithmetic the per-layer metric readers share: device time of the
operations whose names match, counts per unit of work, and the touched
table rows of the hash and VM gathers (the data-dependent part of a
kernel's bytes).  Each reader in `metrics/` holds its own name patterns
and counts."""

from __future__ import annotations

import re

import torch

from portbench.peaks import BF16_FLOPS
from portbench.reference import nerf


def ops_ms(ctx, pattern: str) -> float:
    """Device ms of the traced window's operations matching `pattern`."""
    rx = re.compile(pattern)
    return sum(o.end_ns - o.start_ns for o in ctx["reduced"].ops
               if rx.search(o.name)) / 1e6


def per_unit(ctx, value: float):
    return value / ctx["units"] if ctx["units"] else None


def launches(ctx):
    """Device operations (kernels, copies, fills) per unit of work."""
    return per_unit(ctx, len(ctx["reduced"].ops))


def idle_share(ctx):
    red = ctx["reduced"]
    if red.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - red.busy_s / red.window_s)


def mfu(ctx):
    """The window's model FLOPs against its seconds at the bf16 peak."""
    if ctx["wall_s"] <= 0 or not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * BF16_FLOPS)


def roofline(ctx, pattern: str, bounds_ms: list):
    """100 x the summed least time of the calls over the device time of
    the kernels matching `pattern`; None when either is missing."""
    t = ops_ms(ctx, pattern)
    if t <= 0 or not bounds_ms:
        return None
    return 100.0 * sum(bounds_ms) / t


@torch.no_grad()
def hash_touched_rows(x01, grid: nerf.Grid) -> int:
    """Distinct table rows the corners of points x01 [N, 3] reach, over
    the levels (weights zero outside [0, 1]^3 still read a row)."""
    total = 0
    for lv in range(grid.num_levels):
        _, rows = nerf.hash_corners(x01.float(), grid, lv)
        total += int(rows.unique().numel())
    return total


@torch.no_grad()
def vm_touched_rows(planes, lines, xn) -> int:
    """Distinct plane and line rows the bilinear and linear taps of xn
    [M, 3] reach, over the three branches."""
    total = 0
    for i in range(3):
        m0, m1 = nerf.MAT_IDS[i]
        H, W, _ = planes[i].shape
        L = lines[i].shape[0]

        def base(x, size):
            p = (x + 1.0) * 0.5 * (size - 1)
            return torch.floor(p).long().clamp(0, max(size - 2, 0))

        bx, by = base(xn[:, m0], W), base(xn[:, m1], H)
        row = by * W + bx
        taps = torch.cat([row, row + 1, row + W, row + W + 1])
        total += int(taps.unique().numel())
        b = base(xn[:, nerf.VEC_IDS[i]], L)
        total += int(torch.cat([b, b + 1]).unique().numel())
    return total

