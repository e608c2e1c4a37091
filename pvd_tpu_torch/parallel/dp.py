"""Data-parallel steps over the ray axis (port of pvd_tpu/parallel/dp.py).

One process per device (`parallel/mesh.py`); parameters, optimizer state
and occupancy grids are replicas, and each ray batch is split over the
ranks.  The steps are the single-process steps of `engine/train_steps.py`
(`make_teacher_step`, `make_distill_step`; dp.py:51-375) called with
`group=` a `RayGroup`: each rank draws its `num_rays / world` rays from
its own generator (the JAX package folds the device index into the key),
the gradients are averaged over the ranks before AdamW (its `_pmean_tree` of
the grads, dp.py:47), so every replica takes the same update, and the
logs are averaged too.  As in the JAX package, a step over the ranks
equals a single-process step on the concatenation of their batches, up
to rounding, except that the distillation's point losses are normalised
by each rank's own count of valid samples before the mean (the deviation
documented at dp.py:15-23, kept).  The teacher's PSNR comes from the mean
MSE.  With the error map, the ranks' cells and per-ray losses are
gathered in rank order and every rank applies the same update to its
replica of the map.

The occupancy sweep splits the queried cells over the ranks and gathers
the densities; the eval renderer gives each rank a slice of every chunk's
rays and gathers the images.  Every host decision the ranks must take
together reads reduced values: the renderer's budget ladder takes the
ranks' maximum truncation flag on each rung.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.engine.train_steps import (EvalImage, _check_device,
                                              _param_device, chunk_rays)
from pvd_tpu_torch.models.api import field_density
from pvd_tpu_torch.parallel.mesh import RayGroup
from pvd_tpu_torch.render.occupancy import (OccupancyState,
                                            update_density_grid)
from pvd_tpu_torch.render.renderer import render_rays


def make_dp_occ_update(spec: ModelSpec, rspec: RenderSpec, group: RayGroup,
                       device="cuda"):
    """The occupancy refresh with its density queries split over the
    ranks (dp.py:378-413): each rank queries a slice of the cells (padded
    to a multiple of the world size), the densities are gathered in rank
    order, and the EMA, the bitfield and the mean run on every rank from
    the same values.  Returns occ_update(occ, field, *, full, jitter,
    coords=None), as `train_steps.make_occ_update`; every rank passes the
    same draws."""
    device = resolve_device(device)

    @torch.no_grad()
    def occ_update(occ: OccupancyState, field, *, full: bool, jitter,
                   coords=None) -> OccupancyState:
        _check_device(device, density_grid=occ.density_grid, jitter=jitter,
                      field=_param_device(field))

        def dens(x):
            m = x.shape[0]
            pad = (-m) % group.world
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, 3)])
            local = x[group.ray_slice(x.shape[0])].contiguous()
            sig = field_density(field, spec, local, occ.aabb_train)
            return group.all_gather(sig.float().contiguous())[:m]

        return update_density_grid(occ, dens, rspec, full, jitter, coords)

    return occ_update


def make_dp_eval_renderer(spec: ModelSpec, rspec: RenderSpec,
                          group: RayGroup, chunk: int = 4096,
                          device="cuda"):
    """The chunked full-image renderer over `group` (dp.py:416-528), the
    contract of `train_steps.make_eval_renderer`: the chunk rounds down to
    a multiple of the world size, each rank renders its chunk / world
    rays of every chunk at its own budget (`samples_per_ray` x its rays),
    the ranks' truncation flags are max-reduced once per rung of the
    1x / 4x / 16x ladder, so every rank re-renders the same chunks, and
    the image, depth and weights are gathered at the end.  Every rank
    returns the whole image."""
    device = resolve_device(device)
    chunk = max(group.world, (chunk // group.world) * group.world)
    local = chunk // group.world
    base_spr = rspec.samples_per_ray
    ladder = ([base_spr, base_spr * 4.0, base_spr * 16.0]
              if base_spr > 0 else [0.0])

    def render_chunk(field, occ, pose, intr, head, H, W, spr):
        rs = dataclasses.replace(rspec, samples_per_ray=spr,
                                 max_samples=rspec.max_steps)
        o, d = chunk_rays(pose, intr, H, W, head + group.rank * local, local)
        out = render_rays(field, spec, rs, occ, o, d, training=False,
                          bg_color=1.0, early_stop=True)
        if out["compact"] is None:
            total = out["samples"].mask.sum()
            truncated = torch.zeros((), dtype=torch.bool, device=o.device)
        else:
            total = out["compact"].total
            truncated = out["compact_frac"] > 1.0
        rows = torch.cat([out["image"], out["depth"][:, None],
                          out["weights_sum"][:, None]], dim=-1)
        return rows, total, truncated

    @torch.no_grad()
    def render_image(field, occ: OccupancyState, pose, intrinsics, H: int,
                     W: int) -> EvalImage:
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
        _check_device(device, bitfield=occ.bitfield,
                      field=_param_device(field))
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
            # the ranks' flags, max-reduced: one collective per rung
            truncs = torch.stack([b[2] for b in batch]).float()
            group.max_([truncs])
            truncs = truncs.cpu().numpy() > 0
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
        if n_trunc and group.rank == 0:
            print(f"[eval] WARNING: {n_trunc} chunk(s) still sample-budget-"
                  f"truncated at the final ladder rung (spr={spr:g}); tail "
                  "rays may be zeroed", flush=True)
        mine = torch.stack([outs[h][0] for h in heads])  # [n_heads, local, 5]
        every = group.all_gather(mine[None])  # [world, n_heads, local, 5]
        rows = every.transpose(0, 1).reshape(-1, 5)[:n]
        totals = torch.stack([outs[h][1] for h in heads]).long().sum()
        group.sum_([totals])
        samples = int(totals)
        return EvalImage(rows[:, :3].reshape(H, W, 3),
                         rows[:, 3].reshape(H, W), rows[:, 4].reshape(H, W),
                         rungs, samples, n_trunc)

    return render_image
