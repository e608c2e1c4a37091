"""Linear sampling of channels-minor lines, planes and volumes (port of
pvd_tpu/ops/grid_sample.py: grid_sample_1d :26, grid_sample_2d :41,
grid_sample_3d :65), align_corners=True, zero padding.  The 1-D and 2-D
forms are the JAX package's public helpers (the VM field's queries run
through `ops/vm_sample.py` instead); each sums its corners in JAX's
order.

The plenoxel field's query: coordinates in [-1, 1], channel 0 (x) on the
fastest spatial axis (W), then y on H and z on D, as torch's grid_sample
orders them.  The one route is the JAX package's own sum: the eight corner
rows of the flattened [D * H * W, C] volume, gathered by one
`index_select`, weighted and added in z, y, x corner order, with
autograd's scatter-add (`index_add_`, atomic on the GPU) into one zeroed
gradient as the backward.  On the CPU that gives JAX's sums in JAX's
order.  A corner outside the volume adds nothing (its row is
clamped and its weight zeroed).  `F.grid_sample` on a [1, C, D, H, W] view
computes the same function; `chip_smoke.py` times it beside this one.

The trade-off behind the choice: this route gives the CPU tests JAX's
sums exactly, and it costs speed on the card.  On an H100 80GB HBM3 at
700 W it took 8-9x `F.grid_sample`'s time forward and 2.1-2.8x forward
plus backward, and its scatter led the plenoxel teacher's padded step
(PERF.md §5 and §7).  Moving to `F.grid_sample` or a kernel of its own
would trade that exact CPU parity for the card's time.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int):
    """align_corners=True: -1 -> 0, +1 -> size - 1."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample_1d(line, coords):
    """line: [L, C]; coords: [N] in [-1, 1].  Returns [N, C]."""
    L = line.shape[0]
    p = _unnormalize(coords.float(), L)
    i0 = torch.floor(p).to(torch.int32)
    frac = p - i0
    out = None
    for di, w in ((0, 1.0 - frac), (1, frac)):
        idx = i0 + di
        ok = ((idx >= 0) & (idx <= L - 1)).to(line.dtype)
        rows = line[idx.clamp(0, L - 1).long()]
        term = rows * (w * ok)[:, None]
        out = term if out is None else out + term
    return out


def grid_sample_2d(plane, coords):
    """plane: [H, W, C]; coords: [N, 2] = (x, y), x -> W, y -> H.
    Returns [N, C]."""
    H, W, C = plane.shape
    flat = plane.reshape(H * W, C)
    coords = coords.float()
    px = _unnormalize(coords[..., 0], W)
    py = _unnormalize(coords[..., 1], H)
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx, fy = px - x0, py - y0
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        iy = y0 + dy
        oky = (iy >= 0) & (iy <= H - 1)
        iy_c = iy.clamp(0, H - 1)
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            ix = x0 + dx
            okx = (ix >= 0) & (ix <= W - 1)
            w = wy * wx * (oky & okx).to(flat.dtype)
            rows = flat[(iy_c * W + ix.clamp(0, W - 1)).long()]
            term = rows * w[:, None]
            out = term if out is None else out + term
    return out


def grid_sample_3d(volume, coords):
    """volume: [D, H, W, C]; coords: [N, 3] = (x, y, z), x -> W, y -> H,
    z -> D.  Returns [N, C] in the volume's dtype."""
    D, H, W, C = volume.shape
    flat = volume.reshape(D * H * W, C)
    coords = coords.float()
    px = _unnormalize(coords[..., 0], W)
    py = _unnormalize(coords[..., 1], H)
    pz = _unnormalize(coords[..., 2], D)
    x0, y0, z0 = (torch.floor(p).to(torch.int32) for p in (px, py, pz))
    fx, fy, fz = px - x0, py - y0, pz - z0
    rows, weights = [], []
    for dz, wz in ((0, 1.0 - fz), (1, fz)):
        iz = z0 + dz
        okz = (iz >= 0) & (iz <= D - 1)
        iz_c = iz.clamp(0, D - 1)
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            iy = y0 + dy
            oky = (iy >= 0) & (iy <= H - 1)
            iy_c = iy.clamp(0, H - 1)
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                ix = x0 + dx
                okx = (ix >= 0) & (ix <= W - 1)
                ix_c = ix.clamp(0, W - 1)
                weights.append(wz * wy * wx
                               * (okz & oky & okx).to(flat.dtype))
                rows.append((iz_c * H + iy_c) * W + ix_c)
    # one gather of the 8 corners' rows: its backward is one index_add_
    # into one zeroed gradient of the volume, where eight gathers would
    # each zero a volume-sized buffer
    n = coords.shape[0]
    gathered = flat.index_select(0, torch.stack(rows).reshape(-1).long()) \
        .reshape(8, n, C)
    out = gathered[0] * weights[0][:, None]
    for k in range(1, 8):
        out = out + gathered[k] * weights[k][:, None]
    return out
