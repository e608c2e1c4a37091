"""Occupancy-grid volume rendering (port of pvd_tpu/render/renderer.py).

march -> compact -> field -> composite, as in the JAX package:

  1. `march_rays`: the per-ray t-lattice (t_k = t0 + k * dt_min, or with
     dt_gamma > 0 the geometric t += clip(t * dt_gamma, dt_min, dt_max)),
     an occupancy lookup at each lattice point in the cascade its position
     and its own step pick, and [N, S] sample slots (every lattice slot in
     eval mode, S >= L; the first S occupied points in train mode).
     Kernel K2 (`csrc/march.cu`), or K14 for dt_gamma > 0, on CUDA
     tensors; `march_rays_plain` (the JAX package's plain-lattice path,
     `_t_lattice` + `_occupancy_lookup`) on CPU tensors.
  2. `compact_samples`: the first `budget` valid samples of the batch, in
     ray order (plain PyTorch).
  3. the field on the compacted samples, then `composite_rays_compact`
     (kernels K3 forward, K6 backward).

While a profiler session is open `render_rays` records its stages as
spans (`utils/profiling.py`): `render.march` (near/far and the march; a
replay's holds its near/far alone), `render.compact`, `render.field`
(the samples' positions and the field), `render.background` and
`render.composite`.

Training adds a perturbed march start, a per-ray background, early returns
for distill stages 1 and 2, and the teacher's replay of the student's
samples (`render_rays`).  A field with a background model (bg_radius > 0)
composites over its own background instead of `bg_color`.

`render_stratified` is the occupancy-free path (renderer.py:987-1069, the
reference's `run`): a fixed count of stratified samples per ray, with
optional inverse-CDF resampling around the density peaks, through the
same field queries (`models/api.field_forward`) and a dense composite in
plain PyTorch (`ops/composite.composite_stratified`).

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
from pvd_tpu_torch.models.api import (background_of_rays, background_rgb,
                                      field_forward)
from pvd_tpu_torch.ops.aabb import near_far_from_aabb, polar_from_ray
from pvd_tpu_torch.ops.composite import (composite_rays,
                                         composite_rays_compact,
                                         composite_stratified,
                                         stratified_weights)
from pvd_tpu_torch.ops.fma import fma32
from pvd_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from pvd_tpu_torch.render.occupancy import OccupancyState
from pvd_tpu_torch.utils.profiling import span

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


def dt_max_of(rspec: RenderSpec) -> float:
    """The geometric lattice's largest step 2 sqrt(3) 2^(C-1) / H, as
    float32 (renderer.py:175)."""
    return float(np.float32(2.0 * SQRT3 * 2 ** (rspec.cascades - 1)
                            / rspec.grid_size))


def _march_start(nears, u, dt_min: float):
    return nears if u is None else fma32(dt_min, u, nears)


def _t_lattice_geom(t0, rspec: RenderSpec):
    """[N, L] geometric lattice (dt_gamma > 0) as the JAX scan computes it
    (renderer.py:164-196): t <- t + clip(t * dt_gamma, dt_min, dt_max),
    each op rounded to float32 on its own (the clip keeps XLA from
    contracting the multiply into the add)."""
    g = float(np.float32(rspec.dt_gamma))
    lo, hi = dt_min_of(rspec), dt_max_of(rspec)
    ts = torch.empty(t0.shape[0], rspec.max_steps, device=t0.device)
    t = t0.float()
    for k in range(rspec.max_steps):
        ts[:, k] = t
        t = t + torch.clamp(t * g, lo, hi)
    return ts


def _dt_from_t(t, valid, rspec: RenderSpec):
    """Each sample's step as the exact closed form of its t on the lattice
    (renderer.py:213-228): dt_min, or clip(t * dt_gamma, dt_min, dt_max)
    for dt_gamma > 0; 0 where not `valid` (None: every point is)."""
    if rspec.dt_gamma == 0.0:
        dt = torch.full_like(t, dt_min_of(rspec))
    else:
        g = float(np.float32(rspec.dt_gamma))
        dt = torch.clamp(t * g, dt_min_of(rspec), dt_max_of(rspec))
    return dt if valid is None else torch.where(valid, dt, 0.0)


def _occupancy_lookup(bitfield, pos, dt, rspec: RenderSpec):
    """Occupancy bit at each position [..., 3] (renderer.py:231-256) for the
    step dt (a float, or [...] per point): the cascade is the larger frexp
    exponent of max|pos| and (dt*H)*0.5, each clipped to [0, C-1]."""
    H, C = rspec.grid_size, rspec.cascades
    if C == 1:
        level = None
        mip_bound = min(1.0, rspec.bound)
    else:
        mx = pos.abs().amax(dim=-1)
        lvl_pos = torch.frexp(mx).exponent.clamp(0, C - 1)
        dt = torch.as_tensor(dt, dtype=torch.float32, device=pos.device)
        lvl_dt = torch.frexp(dt * H * 0.5).exponent.clamp(0, C - 1)
        level = torch.maximum(lvl_pos, lvl_dt).long()
        mip_bound = torch.exp2(level.float()).clamp_max(rspec.bound)[..., None]
    n = (0.5 * (pos / mip_bound + 1.0) * H).int().clamp(0, H - 1).long()
    flat = (n[..., 0] * H + n[..., 1]) * H + n[..., 2]
    if level is not None:
        flat = flat + level * (H * H * H)
    return bitfield[flat]


def march_rays_plain(bitfield, rays_o, rays_d, nears, fars,
                     rspec: RenderSpec, u=None) -> MarchedSamples:
    """Plain PyTorch march (renderer.py:643-805, plain-lattice path)."""
    N = rays_o.shape[0]
    S, L = rspec.max_samples, rspec.max_steps
    dt_min = dt_min_of(rspec)
    t0 = _march_start(nears, u, dt_min)
    if rspec.dt_gamma > 0:
        ts = _t_lattice_geom(t0, rspec)
        dts = _dt_from_t(ts, None, rspec)
    else:
        k = torch.arange(L, dtype=torch.float32, device=rays_o.device)
        ts = fma32(k[None, :], dt_min, t0[:, None])  # [N, L]
        dts = dt_min
    pos = fma32(ts[..., None], rays_d[:, None, :], rays_o[:, None, :])
    pos = pos.clamp(-rspec.bound, rspec.bound)
    occ = _occupancy_lookup(bitfield, pos, dts, rspec) \
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
    # dt is the closed form of t, as the lattice applied it
    dt_out = _dt_from_t(t_out, mask, rspec)
    # delta_depth_i = u_i - max(t0, u of the previous valid slot), u = t + dt
    uu = t_out + dt_out
    run = torch.cummax(torch.where(mask, uu, -torch.inf), dim=1).values
    prev = torch.maximum(torch.cat([t0[:, None], run[:, :-1]], dim=1),
                         t0[:, None])
    delta_depth = torch.where(mask, uu - prev, 0.0)
    return MarchedSamples(t=t_out, dt=dt_out, delta_depth=delta_depth,
                          mask=mask, t0=t0)


def _march_cuda(bitfield, rays_o, rays_d, nears, fars, rspec: RenderSpec,
                u) -> MarchedSamples:
    """Check the inputs, launch K2 (K14 on the geometric lattice,
    dt_gamma > 0) and count the launch on `march_rays`."""
    geom = rspec.dt_gamma > 0
    entry = "pvd_march_rays_geom" if geom else "pvd_march_rays"
    extra = {} if u is None else {"u": u}
    dev = kernels.check_cuda(entry, bitfield=bitfield, rays_o=rays_o,
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
        mip_bound0=min(1.0, rspec.bound), dt_gamma=rspec.dt_gamma,
        dt_max=dt_max_of(rspec))
    t = torch.empty(N, S, device=dev)
    dt = torch.empty(N, S, device=dev)
    mask = torch.empty(N, S, dtype=torch.bool, device=dev)
    dd = torch.empty(N, S, device=dev)
    t0 = torch.empty(N, device=dev)
    with torch.cuda.device(dev):
        kernels.launch(entry, rays_o.data_ptr(), rays_d.data_ptr(),
                       nears.data_ptr(), fars.data_ptr(),
                       None if u is None else u.data_ptr(),
                       bitfield.data_ptr(), p, t.data_ptr(), dt.data_ptr(),
                       mask.data_ptr(), dd.data_ptr(), t0.data_ptr(),
                       kernels.stream_ptr(rays_o))
    if geom:
        march_rays.launches_geom += 1
    else:
        march_rays.launches += 1
    return MarchedSamples(t=t, dt=dt, delta_depth=dd, mask=mask, t0=t0)


def march_rays(bitfield, rays_o, rays_d, nears, fars, rspec: RenderSpec,
               u=None) -> MarchedSamples:
    """March rays through the occupancy grid into [N, S] sample slots.

    bitfield [C*H^3] bool; rays_o, rays_d [N, 3]; nears, fars [N];
    u: optional [N] uniform perturbation, t0 = near + dt_min * u.
    K2 on CUDA tensors (K14 when dt_gamma > 0, counted in
    `.launches_geom`), the plain version on CPU tensors.
    """
    if rays_o.device.type == "cpu":
        return march_rays_plain(bitfield, rays_o, rays_d, nears, fars, rspec,
                                u)
    return _march_cuda(bitfield, rays_o, rays_d, nears, fars, rspec, u)


march_rays.launches = march_rays.launches_geom = 0


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
                bg_color=1.0, u=None, want_color: bool = True,
                composite: bool = True, early_stop: bool = False,
                inherited: MarchedSamples | None = None,
                inherited_compact: CompactInfo | None = None,
                inherited_t_c=None):
    """Occupancy-grid render of rays [N, 3] (renderer.py:814-984).

    With rspec.samples_per_ray > 0 the field runs on the first
    `sample_budget(N)` valid samples of the batch and compositing runs on
    that compacted stream (K3 forward, K6 backward); otherwise on the
    padded [N, S] block.

    Training arguments: `u` [N] perturbs each ray's march start by
    dt_min * u; `bg_color` may be per ray [N, 3] (a field with a
    background model, spec.bg_radius > 0, composites over its own
    background instead, on either path); `want_color=False`
    (distill stage 1) or `composite=False` (stage 2) return after the field
    with the point tensors only; `inherited`, `inherited_compact` and
    `inherited_t_c` replay another model's samples (the distill teacher
    neither marches nor perturbs again).

    Returns a dict with samples, compact (or None), budget_hit_frac,
    mask_frac, nears, fars; the point tensors sigma_logit, fea_sc, rgb_l
    (None without color) and mask ([M] compact.valid, or the [N, S] march
    mask), plus compact_t and compact_frac on the compacted path; and,
    when composited, image [N, 3], depth [N], weights_sum [N], weights.
    """
    rays_o = rays_o.reshape(-1, 3).contiguous()
    rays_d = rays_d.reshape(-1, 3).contiguous()
    aabb = occ.aabb_train if training else occ.aabb_infer
    N = rays_o.shape[0]
    budget = rspec.sample_budget(N)
    with span("render.march"):
        nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                         rspec.min_near)
        if inherited is None:
            samples = march_rays(occ.bitfield, rays_o, rays_d, nears, fars,
                                 rspec, u)
        else:
            samples = inherited
        S = samples.mask.shape[1]
        result = {"samples": samples, "compact": None, "nears": nears,
                  "fars": fars,
                  # rays that filled every slot, and the slot utilisation
                  "budget_hit_frac": samples.mask[:, -1].float().mean(),
                  "mask_frac": samples.mask.float().mean()}
    if budget:
        with span("render.compact"):
            # march masks are per-ray prefixes except in eval mode, where
            # every lattice slot keeps its place
            compact = inherited_compact if inherited_compact is not None \
                else compact_samples(samples.mask, budget,
                                     prefix=rspec.max_samples
                                     < rspec.max_steps)
            t_c = inherited_t_c if inherited_t_c is not None else \
                samples.t.reshape(-1)[compact.idx]
        with span("render.field"):
            rid = compact.ray_id
            o_c, d_c, t0_c = rays_o[rid], rays_d[rid], samples.t0[rid]
            xyz = fma32(t_c[:, None], d_c, o_c).clamp(-rspec.bound,
                                                      rspec.bound)
            out_f = field_forward(field, spec, xyz, d_c, aabb,
                                  want_color=want_color)
            result.update(sigma_logit=out_f.sigma_logit, fea_sc=out_f.fea_sc,
                          rgb_l=out_f.rgb, mask=compact.valid,
                          compact=compact, compact_t=t_c,
                          compact_frac=compact.total.float() / budget)
    else:
        with span("render.field"):
            xyz = fma32(samples.t[..., None], rays_d[:, None, :],
                        rays_o[:, None, :]).clamp(-rspec.bound, rspec.bound)
            dirs = rays_d[:, None, :].expand(N, S, 3)
            out_f = field_forward(field, spec, xyz.reshape(-1, 3),
                                  dirs.reshape(-1, 3), aabb,
                                  want_color=want_color)
            result.update(
                sigmas=out_f.sigma.reshape(N, S),
                sigma_logit=out_f.sigma_logit.reshape(N, S),
                fea_sc=(None if out_f.fea_sc is None
                        else out_f.fea_sc.reshape(N, S, -1)),
                rgb_l=(None if out_f.rgb is None
                       else out_f.rgb.reshape(N, S, 3)),
                mask=samples.mask)
    if not (want_color and composite):
        return result
    if spec.bg_radius > 0:  # the field's own background (renderer.py:926)
        with span("render.background"):
            bg_color = background_of_rays(field, spec, rays_o, rays_d)
    with span("render.composite"):
        if budget:
            # dt is the closed form of t; the depth channel's running
            # real-delta sum telescopes to (t + dt) - t0 (renderer.py:
            # 932-935)
            dt_c = _dt_from_t(t_c, compact.valid, rspec)
            t_cum_c = torch.where(compact.valid, t_c + dt_c - t0_c, 0.0)
            ws, depth_raw, image, weights = composite_rays_compact(
                out_f.sigma * rspec.density_scale, out_f.rgb, dt_c, t_cum_c,
                rid, compact.valid, N, early_stop=early_stop)
        else:
            ws, depth_raw, image, weights = composite_rays(
                out_f.sigma.reshape(N, S) * rspec.density_scale,
                out_f.rgb.reshape(N, S, 3), samples.dt, samples.delta_depth,
                samples.mask, early_stop=early_stop)
        image = image + (1.0 - ws)[:, None] * bg_color
        depth = torch.clamp(depth_raw - nears, min=0.0) / (fars - nears
                                                           + 1e-6)
        result.update(image=image, depth=depth, weights_sum=ws,
                      weights=weights)
    return result


def render_stratified(field, spec: ModelSpec, rspec: RenderSpec, aabb,
                      rays_o, rays_d, *,
                      generator: torch.Generator | None = None,
                      perturb: bool = False, bg_color=1.0, draws=None):
    """Fixed-count stratified render of rays [..., 3] (renderer.py:987;
    the reference's `run`, renderer.py:139-317): `rspec.num_steps`
    samples per ray between the ray's near and far on `aabb`, and with
    `rspec.upsample_steps` > 0 that many more drawn from the coarse
    weights' distribution (`sample_pdf`), merged in z order.

    Randomness as in the JAX package's `rng`: with a `generator` (or
    `draws`) the stratified samples are jittered when `perturb` and the
    resampling draws its quantiles; without either, nothing is jittered
    and the quantiles are evenly spaced.  `draws` = (u_strat [N,
    num_steps] or None, u_pdf [N, upsample_steps] or None) passes the
    uniform draws themselves, so a test can hand over the JAX package's.

    Differentiable as the JAX function is: the resampled z and the
    coarse weights carry no gradient.  The field runs on every sample of
    every ray at once, so the caller chunks the rays.  Returns image
    [N, 3], depth [N] (z normalised to [near, far], weighted) and
    weights_sum [N].
    """
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    N = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, rspec.min_near)
    # missed rays would put z at FLT_MAX: keep them finite, weights 0
    miss = nears >= 3.0e38
    nears_s = torch.where(miss, 0.0, nears)
    fars_s = torch.where(miss, 1.0, fars)
    random = generator is not None or draws is not None
    u_strat, u_pdf = draws if draws is not None else (None, None)
    z, sample_dist = stratified_z_vals(nears_s, fars_s, rspec.num_steps,
                                       perturb and random, u=u_strat,
                                       generator=generator)

    def query(z_vals):
        xyz = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
        # jnp.clip to the box, its gradient as ops.activation.clip's
        xyz = torch.minimum(torch.maximum(xyz, aabb[:3]), aabb[3:])
        dirs = rays_d[:, None, :].expand(xyz.shape)
        o = field_forward(field, spec, xyz.reshape(-1, 3),
                          dirs.reshape(-1, 3), aabb, True)
        T = z_vals.shape[1]
        return o.sigma.reshape(N, T), o.rgb.reshape(N, T, 3)

    sigmas, rgbs = query(z)
    if rspec.upsample_steps > 0:
        # importance-resample around the density peaks
        # (the reference's renderer.py:200-255)
        with torch.no_grad():
            weights = stratified_weights(rspec.density_scale * sigmas, z,
                                         sample_dist)
            z_mid = z[..., :-1] + 0.5 * (z[..., 1:] - z[..., :-1])
            new_z = sample_pdf(z_mid, weights[:, 1:-1],
                               rspec.upsample_steps, det=not random,
                               u=u_pdf, generator=generator)
        new_sigmas, new_rgbs = query(new_z)
        # jnp.argsort is stable
        z, order = torch.sort(torch.cat([z, new_z], dim=1), dim=1,
                              stable=True)
        sigmas = torch.gather(torch.cat([sigmas, new_sigmas], dim=1), 1,
                              order)
        rgbs = torch.gather(torch.cat([rgbs, new_rgbs], dim=1), 1,
                            order[..., None].expand(-1, -1, 3))

    ws, weights, image = composite_stratified(
        rspec.density_scale * sigmas, z, sample_dist, rgbs)
    if spec.bg_radius > 0:
        bg_color = background_rgb(
            field, spec, polar_from_ray(rays_o, rays_d, spec.bg_radius),
            rays_d)
    image = image + (1.0 - ws)[:, None] * bg_color
    z_norm = torch.clamp((z - nears_s[:, None])
                         / (fars_s - nears_s + 1e-6)[:, None], 0.0, 1.0)
    depth = torch.sum(weights * z_norm, dim=-1)
    return {"image": image, "depth": depth, "weights_sum": ws}
