"""Training and serving steps (port of pvd_tpu/engine/train_steps.py).

  * the teacher step (train_steps.py:85-118, 193-347), single-step preload
    flavor: GT pixels gathered from the device-resident image, composited
    on a per-pixel random background, a perturbed render, the image MSE,
    then AdamW;
  * the distillation step (train_steps.py:121-190, 456-618), single-step
    flavor: the student renders with a perturbed march, the frozen teacher
    replays the student's compacted samples under `torch.no_grad()` (the
    JAX package's stop_gradient), the three-stage loss, then AdamW;
  * the host-batcher teacher step (train_steps.py:350-453): the same
    core, fed with pixel ids and GT pixels drawn on the host;
  * the occupancy refresh and the chunked full-image eval renderer
    (train_steps.py:621-731).

With `use_error_map` the preload teacher step and the distillation step
draw their pixels by importance from the image's (or pose slot's) 128 x
128 error map and return its updated row; the host step returns the
per-ray losses for the caller's host-resident map (`error_map_update`).
A state with `ema` (a frozen copy of the field) gets its shadow update
after each AdamW update (train_steps.py:248-252).  The scan and
data-parallel flavors are not ported yet (ROADMAP A16, A17).  The state
is updated in place: the trained field's parameters, the optimizer
moments and the EMA copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec, PVDConfig, RenderSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.engine.optim import AdamWState, GroupedAdamW, ema_update
from pvd_tpu_torch.models.api import field_density, vm_density_l1
from pvd_tpu_torch.ops.rays import (draw_error_map_pixels, get_rays,
                                    pixel_dirs, random_pixels, rotate)
from pvd_tpu_torch.render.occupancy import (OccupancyState,
                                            update_density_grid)
from pvd_tpu_torch.render.renderer import render_rays
from pvd_tpu_torch.utils.misc import srgb_to_linear


def _check_device(device: torch.device, **items):
    """Each item (a tensor or a torch.device) lies on `device`'s type."""
    for name, t in items.items():
        where = t if isinstance(t, torch.device) else t.device
        if where.type != device.type:
            raise ValueError(f"{name} is on {where}, expected {device}")


def _param_device(field) -> torch.device:
    return next(field.parameters()).device


@dataclasses.dataclass
class TrainState:
    """A field in training (teacher or student): `field` (an nn.Module,
    updated in place), its AdamW state, its occupancy grid, the step
    counter and, when EMA is on, `ema`: a frozen copy of the field that
    holds the shadow weights."""

    field: Any
    opt_state: AdamWState
    occ: OccupancyState
    step: int = 0
    ema: Any = None


def masked_loss(pred, gt, mask, loss_type: str):
    """Point losses over valid samples only (train_steps.py:44-68); the
    mask count is broadcast over channels (16 x valid for fea_sc)."""
    diff = pred - gt
    if diff.ndim > mask.ndim:
        mask = mask[..., None]
    m = mask.to(diff.dtype)
    diff = diff * m
    n_valid = torch.clamp_min(torch.broadcast_to(m, diff.shape).sum(), 1.0)
    if loss_type == "L2":
        return (diff ** 2).sum() / n_valid
    if loss_type == "normL2":
        return torch.sqrt((diff ** 2).sum() + 1e-12)
    if loss_type == "normL1":
        return diff.abs().sum()
    if loss_type == "smoothL1":
        beta = 0.05
        a = diff.abs()
        return torch.where(a < beta, 0.5 * a * a / beta,
                           a - 0.5 * beta).sum() / n_valid
    raise ValueError(f"unknown loss_type {loss_type}")


def rgb_loss(pred, gt, loss_type: str):
    """Image loss (train_steps.py:71-82)."""
    if loss_type == "L2":
        return ((pred - gt) ** 2).mean()
    if loss_type == "normL2":
        return torch.sqrt(((pred - gt) ** 2).sum() + 1e-12)
    if loss_type == "normL1":
        return (pred - gt).abs().sum()
    if loss_type == "smoothL1":
        beta = 0.05
        a = (pred - gt).abs()
        return torch.where(a < beta, 0.5 * a * a / beta,
                           a - 0.5 * beta).mean()
    raise ValueError(f"unknown loss_type {loss_type}")


def compose_gt(pix, image_channels: int, bg_radius: float, bg):
    """GT pixels for teacher training (train_steps.py:85-99): an RGBA
    image composites rgb * a + bg * (1 - a), on white when a background
    model exists (bg_radius > 0) and on the per-pixel random `bg` [N, 3]
    otherwise.  Returns (gt [N, 3], the background to render with)."""
    if image_channels == 4:
        bg = 1.0 if bg_radius > 0 else bg
        gt = pix[..., :3] * pix[..., 3:] + bg * (1.0 - pix[..., 3:])
    else:
        bg = 1.0
        gt = pix[..., :3]
    return gt, bg


def teacher_loss(field, spec: ModelSpec, rspec: RenderSpec, cfg: PVDConfig,
                 occ, o, d, gt, bg, u):
    """The teacher objective (train_steps.py:102-118): the perturbed
    render's image against gt, plus the VM L1 for a VM field.  Returns
    (loss, (render outputs, per-ray MSE [N]))."""
    out = render_rays(field, spec, rspec, occ, o, d, training=True,
                      bg_color=bg, u=u)
    per_ray = ((out["image"] - gt) ** 2).mean(-1)
    if cfg.loss_type == "L2":
        loss = per_ray.mean()
    else:
        loss = rgb_loss(out["image"], gt, cfg.loss_type)
    if spec.model_type == "vm" and cfg.l1_reg_weight > 0:
        loss = loss + cfg.l1_reg_weight * vm_density_l1(field)
    return loss, (out, per_ray)


def _adamw_step(state: TrainState, opt: GroupedAdamW, loss,
                ema_decay: float):
    """Backward of `loss`, one AdamW update of the state's field, the EMA
    copy's shadow update when the state has one, step + 1; the gradients
    stay in `.grad`."""
    params = dict(state.field.named_parameters())
    loss.backward()
    for p in params.values():  # leaves the loss does not reach
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.update_(params, {n: p.grad for n, p in params.items()},
                state.opt_state)
    if state.ema is not None:
        ema_update(dict(state.ema.named_parameters()), params, ema_decay)
    state.step += 1


@torch.no_grad()
def error_map_update(row, cells, per_ray):
    """The error-map row after a step (train_steps.py:338-346): each
    drawn cell becomes 0.1 x its old weight + 0.9 x the per-ray loss of
    its ray.  Returns a new row.  A cell drawn more than once takes one of
    its rays' values: which one is unspecified (index_put_ without
    accumulate; on CUDA it varies from run to run), as the JAX package's
    `.at[].set` leaves it."""
    new = row.clone()
    new[cells] = 0.1 * row[cells] + 0.9 * per_ray.detach()
    return new


def _draw_bg_u(generator: torch.Generator, n: int, device):
    """The per-ray background [n, 3] and march perturbation u [n], in
    that order from `generator`."""
    bg = torch.rand(n, 3, generator=generator, device=device)
    u = torch.rand(n, generator=generator, device=device)
    return bg, u


def _zero_grads(field):
    for p in field.parameters():
        p.grad = None


def _teacher_core(spec: ModelSpec, rspec: RenderSpec, opt: GroupedAdamW,
                  cfg: PVDConfig, image_channels: int, device: torch.device):
    """teacher_step_core(state, o, d, pix, bg, u, per_ray=False) -> (state,
    metrics), and the per-ray losses [N] after them with per_ray: the
    color-space conversion, `compose_gt` (GT on white and the field's own
    background when it has one), the loss, its gradients (left in the
    field's `.grad`), one AdamW update, the EMA update and step + 1
    (train_steps.py: 254-281, 382-409)."""

    def teacher_step_core(state: TrainState, o, d, pix, bg, u,
                          per_ray: bool = False):
        _check_device(device, field=_param_device(state.field), rays_o=o,
                      pix=pix)
        if cfg.color_space == "linear":
            pix = torch.cat([srgb_to_linear(pix[..., :3]), pix[..., 3:]],
                            dim=-1)
        gt, bg_r = compose_gt(pix, image_channels, cfg.bg_radius, bg)
        _zero_grads(state.field)
        loss, (out, ray_loss) = teacher_loss(state.field, spec, rspec, cfg,
                                             state.occ, o, d, gt, bg_r, u)
        _adamw_step(state, opt, loss, cfg.ema_decay)
        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                "psnr": -10.0 * torch.log10(
                    ((out["image"] - gt) ** 2).mean() + 1e-12),
                "budget_hit": out["budget_hit_frac"],
                "mask_frac": out["mask_frac"]}
            if "compact_frac" in out:
                metrics["compact_frac"] = out["compact_frac"]
        if per_ray:
            return state, metrics, ray_loss.detach()
        return state, metrics

    return teacher_step_core


def make_teacher_step(spec: ModelSpec, rspec: RenderSpec, opt: GroupedAdamW,
                      cfg: PVDConfig, intrinsics, H: int, W: int,
                      image_channels: int, device="cuda",
                      use_error_map: bool = False):
    """One teacher training step, single-step preload flavor
    (train_steps.py:193-347).

    Returns step(state, pose [4, 4], image_flat [H*W, C], generator) ->
    (state, metrics): it draws `cfg.num_rays` uniform pixels, then the
    per-pixel background [N, 3] and the march perturbation u [N], all from
    `generator`, gathers the pixels from `image_flat` (on the device) and
    calls `step.core`, i.e. teacher_step_core(state, o, d, pix, bg, u) ->
    (state, metrics): the color-space conversion, `compose_gt` (GT on white
    and the field's own background when it has one), the loss,
    its gradients (left in the field's `.grad`), one AdamW update and
    step + 1.  Metrics: loss, psnr (of the batch against its gt),
    budget_hit, mask_frac and, on the compacted path, compact_frac.

    With `use_error_map` it is step(state, pose, image_flat, emap_row
    [128 * 128], generator) -> (state, new_row, metrics): the pixels are
    drawn by importance from the image's error-map row
    (`ops.rays.draw_error_map_pixels`: the cells, then their jitters),
    then the background and u, and `step.with_rays(state, pose,
    image_flat, emap_row, inds, cells, bg, u)` runs the rest: the core,
    then `error_map_update` of the row with the per-ray losses.
    """
    device = resolve_device(device)
    intr = tuple(float(v) for v in intrinsics)
    core = _teacher_core(spec, rspec, opt, cfg, image_channels, device)

    def run(state, pose, image_flat, inds, bg, u, per_ray=False):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        rays = get_rays(pose[None], intr, H, W, inds)
        return core(state, rays["rays_o"][0].contiguous(),
                    rays["rays_d"][0].contiguous(), image_flat[inds], bg, u,
                    per_ray)

    if use_error_map:
        def with_rays(state, pose, image_flat, emap_row, inds, cells, bg, u):
            state, metrics, ray_loss = run(state, pose, image_flat, inds, bg,
                                           u, per_ray=True)
            return state, error_map_update(emap_row, cells, ray_loss), \
                metrics

        def step(state: TrainState, pose, image_flat, emap_row,
                 generator: torch.Generator):
            inds, cells = draw_error_map_pixels(generator, emap_row,
                                                cfg.num_rays, H, W)
            bg, u = _draw_bg_u(generator, inds.shape[0], device)
            return with_rays(state, pose, image_flat, emap_row, inds, cells,
                             bg, u)

        step.with_rays = with_rays
    else:
        def step(state: TrainState, pose, image_flat,
                 generator: torch.Generator):
            inds = random_pixels(generator, cfg.num_rays, H, W, device)
            bg, u = _draw_bg_u(generator, inds.shape[0], device)
            return run(state, pose, image_flat, inds, bg, u)

    step.core = core
    return step


def make_teacher_step_host(spec: ModelSpec, rspec: RenderSpec,
                           opt: GroupedAdamW, cfg: PVDConfig, intrinsics,
                           H: int, W: int, image_channels: int,
                           device="cuda", use_error_map: bool = False):
    """One teacher step fed by the host batcher (`data/raybatch.py`, the
    preload=False path; train_steps.py:350-453, single step).

    Returns step(state, pose [4, 4], inds [N], pix [N, C], generator) ->
    (state, metrics): the batch's pixel ids and GT pixels come from the
    host (numpy or tensors; copied to the device through pinned memory
    here, so the host does not wait for the queued steps), the
    rays from `step.rays(pose, inds)` (`pixel_dirs` rotated by the pose),
    then the per-pixel background [N, 3] and the march perturbation u [N]
    are drawn from `generator` and `step.core` (make_teacher_step's
    core: the same loss and AdamW step) runs.  With `use_error_map` it
    returns (state, per_ray [N], metrics): the caller drew the pixels from
    its host-resident map (`ops.rays.draw_error_map_inds_np`) and updates
    it with the per-ray losses (train_steps.py:440-445).
    """
    device = resolve_device(device)
    intr = tuple(float(v) for v in intrinsics)
    core = _teacher_core(spec, rspec, opt, cfg, image_channels, device)

    def upload(a, dtype):
        """A host batch array on the device.  A copy from pageable memory
        would wait for the stream's queued work; from a pinned buffer of
        the caching host allocator (which keeps it until the copy is
        done) the host goes on queueing the step."""
        t = torch.as_tensor(a, dtype=dtype)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def rays(pose, inds):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        inds = upload(inds, torch.int32).long()
        d = rotate(pixel_dirs(intr, inds, H, W), pose[:3, :3])
        return pose[:3, 3].expand_as(d).contiguous(), d.contiguous()

    def step(state: TrainState, pose, inds, pix, generator: torch.Generator):
        o, d = rays(pose, inds)
        pix = upload(pix, torch.float32)
        bg, u = _draw_bg_u(generator, o.shape[0], device)
        if not use_error_map:
            return core(state, o, d, pix, bg, u)
        state, metrics, ray_loss = core(state, o, d, pix, bg, u,
                                        per_ray=True)
        return state, ray_loss, metrics

    step.rays = rays
    step.core = core
    return step


def distill_loss(student, teacher, spec_stu: ModelSpec, spec_tea: ModelSpec,
                 rspec: RenderSpec, cfg: PVDConfig, stage: int, occ,
                 occ_tea, o, d, bg, u, step: int):
    """The three-stage distillation objective (train_steps.py:121-190).

    o, d [N, 3] rays; bg [N, 3] background; u [N] march perturbation;
    step: the student's step counter (the feature-loss rate decays
    0.995^step).  At stage 3 a model with a background model composites
    over its own background instead of `bg` (render_rays).  Returns (loss,
    (logs, per_ray)); gradients reach the student only.
    """
    both_have_fea = "tensors" not in (spec_stu.model_type,
                                      spec_tea.model_type)
    want_color = stage >= 2
    composite = stage == 3
    out_s = render_rays(student, spec_stu, rspec, occ, o, d, training=True,
                        bg_color=bg, u=u, want_color=want_color,
                        composite=composite)
    with torch.no_grad():
        out_t = render_rays(teacher, spec_tea, rspec, occ_tea, o, d,
                            training=True, bg_color=bg,
                            want_color=want_color, composite=composite,
                            inherited=out_s["samples"],
                            inherited_compact=out_s["compact"],
                            inherited_t_c=out_s.get("compact_t"))
    mask = out_s["mask"]
    # feature-loss rate decays x0.995 per step, in float32
    rate_fea = float(np.float32(cfg.loss_rate_fea_sc)
                     * np.float32(0.995) ** np.float32(step))
    logs = {"budget_hit": out_s["budget_hit_frac"],
            "mask_frac": out_s["mask_frac"]}
    if "compact_frac" in out_s:
        logs["compact_frac"] = out_s["compact_frac"]
    loss = 0.0
    if both_have_fea:
        l_fea = masked_loss(out_s["fea_sc"], out_t["fea_sc"], mask,
                            cfg.loss_type)
        loss = loss + rate_fea * l_fea
        logs["loss_fea_sc"] = l_fea
    else:
        logs["loss_fea_sc"] = torch.zeros((), device=o.device)
    if stage >= 2:
        l_sigma = masked_loss(out_s["sigma_logit"], out_t["sigma_logit"],
                              mask, cfg.loss_type)
        l_color = masked_loss(out_s["rgb_l"], out_t["rgb_l"], mask,
                              cfg.loss_type)
        loss = loss + cfg.loss_rate_sigma * l_sigma
        loss = loss + cfg.loss_rate_color * l_color
        logs["loss_sigma"] = l_sigma
        logs["loss_color"] = l_color
    per_ray = None
    if stage == 3:
        l_rgb = rgb_loss(out_s["image"], out_t["image"], cfg.loss_type)
        per_ray = ((out_s["image"] - out_t["image"]) ** 2).mean(-1)
        loss = loss + cfg.loss_rate_rgb * l_rgb
        if spec_stu.model_type == "vm" and cfg.l1_reg_weight > 0:
            loss = loss + cfg.l1_reg_weight * vm_density_l1(student)
        logs["loss_rgb"] = l_rgb
        logs["psnr"] = -10.0 * torch.log10(
            ((out_s["image"] - out_t["image"]) ** 2).mean() + 1e-12)
    logs["loss"] = loss
    return loss, (logs, per_ray)


def make_distill_step(spec_stu: ModelSpec, spec_tea: ModelSpec,
                      rspec: RenderSpec, opt: GroupedAdamW, cfg: PVDConfig,
                      intrinsics, H: int, W: int, stage: int,
                      device="cuda", use_error_map: bool = False):
    """One distillation step of `stage` (1: features, 2: + point sigma and
    color, 3: + RGB and the VM L1), single-step flavor
    (train_steps.py:456-524).

    Returns step(state, teacher, occ_tea, pose [4, 4], generator) ->
    (state, logs): it draws `cfg.num_rays` uniform pixels, then a per-ray
    background [N, 3] and the march perturbation u [N], all from
    `generator`, and calls `step.core`, i.e.
    distill_step_core(state, teacher, occ_tea, o, d, bg, u) -> (state,
    logs): the loss, its gradients (left in the student's `.grad`), one
    AdamW update, the EMA update and step + 1.

    With `use_error_map` it is step(state, teacher, occ_tea, pose,
    emap_row [128 * 128], generator) -> (state, new_row, logs): the pixels
    are drawn by importance from the pose slot's error-map row, then the
    background and u, and `step.with_rays(state, teacher, occ_tea, pose,
    emap_row, inds, cells, bg, u)` runs the rest; at stage 3 with the L2
    loss the row takes the per-ray RGB losses (`error_map_update`), else
    it is returned unchanged (train_steps.py:597-618).
    """
    if stage not in (1, 2, 3):
        raise ValueError(f"stage must be 1, 2 or 3, got {stage}")
    if stage == 1 and "tensors" in (spec_stu.model_type,
                                    spec_tea.model_type):
        raise ValueError("stage 1 has no loss when either side is a "
                         "plenoxel field (it has no fea_sc): the Trainer "
                         "and the CLI skip it (stage1_iters = 0)")
    device = resolve_device(device)
    intr = tuple(float(v) for v in intrinsics)

    def distill_step_core(state: TrainState, teacher, occ_tea, o, d, bg, u,
                          per_ray: bool = False):
        _check_device(device, student=_param_device(state.field),
                      teacher=_param_device(teacher), rays_o=o)
        _zero_grads(state.field)
        loss, (logs, ray_loss) = distill_loss(
            state.field, teacher, spec_stu, spec_tea, rspec, cfg, stage,
            state.occ, occ_tea, o, d, bg, u, state.step)
        _adamw_step(state, opt, loss, cfg.ema_decay)
        logs = {k: v.detach() for k, v in logs.items()}
        if per_ray:  # None before stage 3
            return state, logs, (None if ray_loss is None
                                 else ray_loss.detach())
        return state, logs

    def run(state, teacher, occ_tea, pose, inds, bg, u, per_ray=False):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        rays = get_rays(pose[None], intr, H, W, inds)
        return distill_step_core(state, teacher, occ_tea,
                                 rays["rays_o"][0].contiguous(),
                                 rays["rays_d"][0].contiguous(), bg, u,
                                 per_ray)

    if use_error_map:
        update_map = stage == 3 and cfg.loss_type == "L2"

        def with_rays(state, teacher, occ_tea, pose, emap_row, inds, cells,
                      bg, u):
            state, logs, ray_loss = run(state, teacher, occ_tea, pose, inds,
                                        bg, u, per_ray=True)
            if update_map:
                emap_row = error_map_update(emap_row, cells, ray_loss)
            return state, emap_row, logs

        def step(state: TrainState, teacher, occ_tea, pose, emap_row,
                 generator: torch.Generator):
            inds, cells = draw_error_map_pixels(generator, emap_row,
                                                cfg.num_rays, H, W)
            bg, u = _draw_bg_u(generator, inds.shape[0], device)
            return with_rays(state, teacher, occ_tea, pose, emap_row, inds,
                             cells, bg, u)

        step.with_rays = with_rays
    else:
        def step(state: TrainState, teacher, occ_tea, pose,
                 generator: torch.Generator):
            inds = random_pixels(generator, cfg.num_rays, H, W, device)
            bg, u = _draw_bg_u(generator, inds.shape[0], device)
            return run(state, teacher, occ_tea, pose, inds, bg, u)

    step.core = distill_step_core
    return step


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
                      field=_param_device(field))

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
