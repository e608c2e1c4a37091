"""Serving-side steps (port of pvd_tpu/engine/train_steps.py:621-731):
the occupancy refresh and the chunked full-image eval renderer.  The
training steps come with the distill slice (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import field_density
from pvd_tpu_torch.ops.rays import pixel_dirs, rotate
from pvd_tpu_torch.render.occupancy import (OccupancyState,
                                            update_density_grid)
from pvd_tpu_torch.render.renderer import render_rays


def _check_device(device: torch.device, **tensors):
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def make_occ_update(spec: ModelSpec, rspec: RenderSpec, device="cuda"):
    """Occupancy-grid refresh (renderer.py:648-775 in the reference).

    Returns occ_update(occ, field, *, full, jitter, coords=None); see
    `update_density_grid` for the shapes of the random inputs.
    """
    device = resolve_device(device)

    @torch.no_grad()
    def occ_update(occ: OccupancyState, field, *, full: bool, jitter,
                   coords=None) -> OccupancyState:
        _check_device(device, density_grid=occ.density_grid, jitter=jitter,
                      encoder=field.encoder)

        def dens(x):
            return field_density(field, spec, x, occ.aabb_train)

        return update_density_grid(occ, dens, rspec, full, jitter, coords)

    return occ_update


class EvalImage(NamedTuple):
    image: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    weights_sum: torch.Tensor  # [H, W]
    rungs: int  # budget-ladder rungs dispatched
    samples: int  # valid samples (pre-cap) of the accepted chunk renders
    truncated_chunks: int  # chunks still over budget at the last rung


def chunk_rays(pose, intrinsics, H: int, W: int, head: int, chunk: int):
    """Rays of pixels [head, head + chunk) in scanline order; the tail past
    the image repeats the last pixel (train_steps.py:672-676)."""
    inds = head + torch.arange(chunk, device=pose.device)
    inds = torch.clamp(inds, max=H * W - 1)
    d = rotate(pixel_dirs(intrinsics, inds, H, W), pose[:3, :3])
    o = pose[:3, 3].expand_as(d)
    return o, d


def make_eval_renderer(spec: ModelSpec, rspec: RenderSpec,
                       chunk: int = 4096, device="cuda"):
    """Chunked full-image inference renderer (train_steps.py:634-731).

    Eval marches the full trajectory (max_samples = max_steps) and renders
    each chunk on the compacted sample stream at a per-chunk budget of
    `samples_per_ray * chunk`.  A chunk whose valid samples exceed the
    budget is re-rendered on the next rung of a 1x / 4x / 16x budget
    ladder; all chunks of a rung are launched before their truncation
    flags are read back, once per rung.

    Returns render_image(field, occ, pose [4, 4], intrinsics, H, W) ->
    EvalImage.
    """
    device = resolve_device(device)
    base_spr = rspec.samples_per_ray
    ladder = ([base_spr, base_spr * 4.0, base_spr * 16.0]
              if base_spr > 0 else [0.0])

    def render_chunk(field, occ, pose, intr, head, H, W, spr):
        rs = dataclasses.replace(rspec, samples_per_ray=spr,
                                 max_samples=rspec.max_steps)
        o, d = chunk_rays(pose, intr, H, W, head, chunk)
        out = render_rays(field, spec, rs, occ, o, d, training=False,
                          bg_color=1.0, early_stop=True)
        if out["compact"] is None:
            total = out["samples"].mask.sum()
            truncated = torch.zeros((), dtype=torch.bool, device=o.device)
        else:
            total = out["compact"].total
            truncated = out["compact_frac"] > 1.0
        return out["image"], out["depth"], out["weights_sum"], total, \
            truncated

    @torch.no_grad()
    def render_image(field, occ: OccupancyState, pose, intrinsics, H: int,
                     W: int) -> EvalImage:
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
        _check_device(device, bitfield=occ.bitfield, encoder=field.encoder)
        intr = tuple(float(v) for v in intrinsics)
        n = H * W
        heads = list(range(0, n, chunk))
        outs = {}
        pending = heads
        rungs = 0
        for spr in ladder:
            rungs += 1
            batch = [render_chunk(field, occ, pose, intr, h, H, W, spr)
                     for h in pending]
            # one readback per rung
            truncs = torch.stack([b[4] for b in batch]).cpu().numpy()
            last = spr == ladder[-1]
            retry = []
            for h, b, trunc in zip(pending, batch, truncs):
                if not last and bool(trunc):
                    retry.append(h)
                else:
                    outs[h] = b
            pending = retry
            if not pending:
                break
        n_trunc = int(truncs.sum()) if last else 0
        if n_trunc:
            print(f"[eval] WARNING: {n_trunc} chunk(s) still sample-budget-"
                  f"truncated at the final ladder rung (spr={spr:g}); tail "
                  "rays may be zeroed", flush=True)
        rows = [min(h + chunk, n) - h for h in heads]
        img = torch.cat([outs[h][0][:r] for h, r in zip(heads, rows)])
        dep = torch.cat([outs[h][1][:r] for h, r in zip(heads, rows)])
        ws = torch.cat([outs[h][2][:r] for h, r in zip(heads, rows)])
        samples = int(torch.stack([outs[h][3] for h in heads]).sum())
        return EvalImage(img.reshape(H, W, 3), dep.reshape(H, W),
                         ws.reshape(H, W), rungs, samples, n_trunc)

    return render_image
