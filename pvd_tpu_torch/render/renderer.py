"""Occupancy-grid volume rendering (port of pvd_tpu/render/renderer.py).

march -> compact -> field -> composite, as in the JAX package:

  1. `march_rays`: the per-ray t-lattice t_k = t0 + k * dt_min, an
     occupancy lookup at each lattice point, and [N, S] sample slots
     (every lattice slot in eval mode, S >= L; the first S occupied points
     in train mode).  Kernel K2 (`csrc/march.cu`) on CUDA tensors;
     `march_rays_plain` (the JAX package's plain-lattice path,
     `_t_lattice` + `_occupancy_lookup`) on CPU tensors.
  2. `compact_samples`: the first `budget` valid samples of the batch, in
     ray order (plain PyTorch).
  3. the field on the compacted samples, then `composite_rays_compact`
     (kernel K3).

The TPU's probe-mask marches, window-hierarchical first-S and lazy-t
layouts produce the same samples and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pvd_tpu_torch import kernels
from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.models.api import field_forward
from pvd_tpu_torch.ops.aabb import near_far_from_aabb
from pvd_tpu_torch.ops.composite import composite_rays, composite_rays_compact
from pvd_tpu_torch.ops.fma import fma32
from pvd_tpu_torch.render.occupancy import OccupancyState

SQRT3 = math.sqrt(3.0)


class MarchedSamples(NamedTuple):
    t: torch.Tensor  # [N, S] sample distances (0 in invalid slots)
    dt: torch.Tensor  # [N, S] integration step of each sample
    delta_depth: torch.Tensor  # [N, S] marched distance since the last sample
    mask: torch.Tensor  # [N, S] bool validity
    t0: torch.Tensor  # [N] march start (near, possibly perturbed)


class CompactInfo(NamedTuple):
    idx: torch.Tensor  # [M] int64 flat row-major index into [N * S]
    valid: torch.Tensor  # [M] bool; False slots are padding
    ray_id: torch.Tensor  # [M] int64 owning ray (0 on padding)
    total: torch.Tensor  # scalar int64: valid samples in the batch (pre-cap)


def dt_min_of(rspec: RenderSpec) -> float:
    """The lattice step as float32 (the JAX package's Python float, rounded
    once where it meets an f32 array)."""
    return float(np.float32(2.0 * SQRT3 / rspec.max_steps))


def _check_march_spec(rspec: RenderSpec):
    if rspec.dt_gamma != 0.0:
        raise NotImplementedError(
            "dt_gamma > 0 (the t += clip(t*dt_gamma) lattice) is not ported "
            "yet: ROADMAP B3")


def _march_start(nears, u, dt_min: float):
    return nears if u is None else fma32(dt_min, u, nears)


def _occupancy_lookup(bitfield, pos, dt: float, rspec: RenderSpec):
    """Occupancy bit at each position [..., 3] (renderer.py:231-256): the
    cascade is the larger frexp exponent of max|pos| and dt*H/2, each
    clipped to [0, C-1]."""
    H, C = rspec.grid_size, rspec.cascades
    if C == 1:
        level = None
        mip_bound = min(1.0, rspec.bound)
    else:
        mx = pos.abs().amax(dim=-1)
        lvl_pos = torch.frexp(mx).exponent.clamp(0, C - 1)
        _, e_dt = math.frexp(float(np.float32(np.float32(dt) * np.float32(H))
                                   * np.float32(0.5)))
        level = lvl_pos.clamp_min(min(max(e_dt, 0), C - 1)).long()
        mip_bound = torch.exp2(level.float()).clamp_max(rspec.bound)[..., None]
    n = (0.5 * (pos / mip_bound + 1.0) * H).int().clamp(0, H - 1).long()
    flat = (n[..., 0] * H + n[..., 1]) * H + n[..., 2]
    if level is not None:
        flat = flat + level * (H * H * H)
    return bitfield[flat]


def march_rays_plain(bitfield, rays_o, rays_d, nears, fars,
                     rspec: RenderSpec, u=None) -> MarchedSamples:
    """Plain PyTorch march (renderer.py:643-805, plain-lattice path)."""
    _check_march_spec(rspec)
    N = rays_o.shape[0]
    S, L = rspec.max_samples, rspec.max_steps
    dt_min = dt_min_of(rspec)
    t0 = _march_start(nears, u, dt_min)
    k = torch.arange(L, dtype=torch.float32, device=rays_o.device)
    ts = fma32(k[None, :], dt_min, t0[:, None])  # [N, L]
    pos = fma32(ts[..., None], rays_d[:, None, :], rays_o[:, None, :])
    pos = pos.clamp(-rspec.bound, rspec.bound)
    occ = _occupancy_lookup(bitfield, pos, dt_min, rspec) \
        & (ts < fars[:, None])
    if S >= L:  # eval: every lattice point keeps its slot
        mask = torch.zeros(N, S, dtype=torch.bool, device=rays_o.device)
        mask[:, :L] = occ
        t_lat = torch.zeros(N, S, device=rays_o.device)
        t_lat[:, :L] = ts
    else:  # train: the first S occupied points, in order
        rank = torch.cumsum(occ.long(), dim=1) - 1
        keep = occ & (rank < S)
        slot = torch.where(keep, rank, S)  # dropped points park at column S
        t_lat = torch.zeros(N, S + 1, device=rays_o.device)
        t_lat.scatter_(1, slot, ts)
        t_lat = t_lat[:, :S]
        mask = torch.arange(S, device=rays_o.device)[None, :] \
            < keep.sum(dim=1, keepdim=True)
    t_out = torch.where(mask, t_lat, 0.0)
    dt_out = torch.where(mask, dt_min, 0.0)
    # delta_depth_i = u_i - max(t0, u of the previous valid slot), u = t + dt
    uu = t_out + dt_out
    run = torch.cummax(torch.where(mask, uu, -torch.inf), dim=1).values
    prev = torch.maximum(torch.cat([t0[:, None], run[:, :-1]], dim=1),
                         t0[:, None])
    delta_depth = torch.where(mask, uu - prev, 0.0)
    return MarchedSamples(t=t_out, dt=dt_out, delta_depth=delta_depth,
                          mask=mask, t0=t0)


def march_rays(bitfield, rays_o, rays_d, nears, fars, rspec: RenderSpec,
               u=None) -> MarchedSamples:
    """March rays through the occupancy grid into [N, S] sample slots.

    bitfield [C*H^3] bool; rays_o, rays_d [N, 3]; nears, fars [N];
    u: optional [N] uniform perturbation, t0 = near + dt_min * u.
    K2 on CUDA tensors, the plain version on CPU tensors.
    """
    if rays_o.device.type == "cpu":
        return march_rays_plain(bitfield, rays_o, rays_d, nears, fars, rspec,
                                u)
    _check_march_spec(rspec)
    extra = {} if u is None else {"u": u}
    dev = kernels.check_cuda("march_rays", bitfield=bitfield, rays_o=rays_o,
                             rays_d=rays_d, nears=nears, fars=fars, **extra)
    N = rays_o.shape[0]
    S, L, H, C = (rspec.max_samples, rspec.max_steps, rspec.grid_size,
                  rspec.cascades)
    if bitfield.dtype != torch.bool or bitfield.shape != (C * H * H * H,):
        raise ValueError(f"bitfield must be bool [{C * H * H * H}]")
    for name, t, shape in (("rays_o", rays_o, (N, 3)),
                           ("rays_d", rays_d, (N, 3)), ("nears", nears, (N,)),
                           ("fars", fars, (N,))) + \
            ((("u", u, (N,)),) if u is not None else ()):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"march_rays: {name} must be float32 {shape}")
    p = kernels.MarchParams(
        n_rays=N, n_steps=L, max_samples=S, grid=H, cascades=C,
        bound=rspec.bound, dt_min=dt_min_of(rspec),
        mip_bound0=min(1.0, rspec.bound))
    t = torch.empty(N, S, device=dev)
    dt = torch.empty(N, S, device=dev)
    mask = torch.empty(N, S, dtype=torch.bool, device=dev)
    dd = torch.empty(N, S, device=dev)
    t0 = torch.empty(N, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_march_rays", rays_o.data_ptr(), rays_d.data_ptr(),
                       nears.data_ptr(), fars.data_ptr(),
                       None if u is None else u.data_ptr(),
                       bitfield.data_ptr(), p, t.data_ptr(), dt.data_ptr(),
                       mask.data_ptr(), dd.data_ptr(), t0.data_ptr(),
                       kernels.stream_ptr(rays_o))
    march_rays.launches += 1
    return MarchedSamples(t=t, dt=dt, delta_depth=dd, mask=mask, t0=t0)


march_rays.launches = 0


def compact_samples(mask, budget: int, prefix: bool = False) -> CompactInfo:
    """First `budget` valid positions of mask [N, S], row-major
    (renderer.py:123-161).

    prefix=True requires each row's valid slots to be a prefix (train-mode
    march output); over-budget batches keep whole leading rays.  Both modes
    give the JAX package's idx / valid / ray_id / total.
    """
    N, S = mask.shape
    dev = mask.device
    mslot = torch.arange(budget, device=dev)
    if prefix:
        rcnt = mask.sum(dim=1)
        total = rcnt.sum()
        rbase = torch.cumsum(rcnt, 0) - rcnt  # exclusive
        # owner of slot s: the last ray whose first slot is <= s
        ray = torch.searchsorted(rbase, mslot, right=True) - 1
        valid = mslot < torch.clamp(total, max=budget)
        ray = torch.where(valid, ray, 0)
        idx = torch.where(valid, ray * S + (mslot - rbase[ray]), 0)
        return CompactInfo(idx=idx, valid=valid, ray_id=ray, total=total)
    cnt = torch.cumsum(mask.reshape(-1).long(), 0)
    total = cnt[-1]
    # flat position of the (s+1)-th valid slot
    idx = torch.searchsorted(cnt, mslot + 1)
    valid = mslot < torch.clamp(total, max=budget)
    idx = torch.where(valid, idx, 0)
    return CompactInfo(idx=idx, valid=valid, ray_id=idx // S, total=total)


def render_rays(field, spec: ModelSpec, rspec: RenderSpec,
                occ: OccupancyState, rays_o, rays_d, *, training: bool,
                bg_color=1.0, early_stop: bool = False):
    """Occupancy-grid render of rays [N, 3] (renderer.py:814-984).

    With rspec.samples_per_ray > 0 the field runs on the first
    `sample_budget(N)` valid samples of the batch and compositing runs on
    that compacted stream (K3); otherwise on the padded [N, S] block.
    Returns a dict with image [N, 3], depth [N], weights_sum [N], weights,
    samples, compact (or None), compact_frac, nears, fars.
    """
    rays_o = rays_o.reshape(-1, 3).contiguous()
    rays_d = rays_d.reshape(-1, 3).contiguous()
    aabb = occ.aabb_train if training else occ.aabb_infer
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, rspec.min_near)
    N = rays_o.shape[0]
    budget = rspec.sample_budget(N)
    samples = march_rays(occ.bitfield, rays_o, rays_d, nears, fars, rspec)
    S = samples.mask.shape[1]
    result = {"samples": samples, "compact": None, "nears": nears,
              "fars": fars}
    if budget:
        # march masks are per-ray prefixes except in eval mode, where every
        # lattice slot keeps its place
        compact = compact_samples(samples.mask, budget,
                                  prefix=rspec.max_samples < rspec.max_steps)
        t_c = samples.t.reshape(-1)[compact.idx]
        rid = compact.ray_id
        o_c, d_c, t0_c = rays_o[rid], rays_d[rid], samples.t0[rid]
        xyz = fma32(t_c[:, None], d_c, o_c).clamp(-rspec.bound, rspec.bound)
        out_f = field_forward(field, spec, xyz, d_c, aabb)
        # dt is dt_min on every valid slot; the depth channel's running
        # real-delta sum telescopes to (t + dt) - t0 (renderer.py:932-935)
        dt_c = torch.where(compact.valid, dt_min_of(rspec), 0.0)
        t_cum_c = torch.where(compact.valid, t_c + dt_c - t0_c, 0.0)
        ws, depth_raw, image, weights = composite_rays_compact(
            out_f.sigma * rspec.density_scale, out_f.rgb, dt_c, t_cum_c,
            rid, compact.valid, N, early_stop=early_stop)
        result.update(compact=compact,
                      compact_frac=compact.total.float() / budget)
    else:
        xyz = fma32(samples.t[..., None], rays_d[:, None, :],
                    rays_o[:, None, :]).clamp(-rspec.bound, rspec.bound)
        dirs = rays_d[:, None, :].expand(N, S, 3)
        out_f = field_forward(field, spec, xyz.reshape(-1, 3),
                              dirs.reshape(-1, 3), aabb)
        ws, depth_raw, image, weights = composite_rays(
            out_f.sigma.reshape(N, S) * rspec.density_scale,
            out_f.rgb.reshape(N, S, 3), samples.dt, samples.delta_depth,
            samples.mask, early_stop=early_stop)
    image = image + (1.0 - ws)[:, None] * bg_color
    depth = torch.clamp(depth_raw - nears, min=0.0) / (fars - nears + 1e-6)
    result.update(image=image, depth=depth, weights_sum=ws, weights=weights)
    return result
