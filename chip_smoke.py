#!/usr/bin/env python3
"""Smoke test of pvd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from pvd_tpu_torch/csrc (nvcc, sm_90a).
2. Drives the serving path at the full INGP width (14 levels x 2, 2^19
   table, bf16 heads, grid 128^3, 1024-step march, 16 samples/ray budget)
   with seeded random weights: one full occupancy sweep (2,097,152 density
   queries), then three 800x800 renders with make_eval_renderer on a
   3.18%-occupancy object grid.
3. Drives the hash -> VM distillation step at full width (VM 300^3, ranks
   16/48; the same hash teacher; 8192 rays, budget 131,072 samples, bf16
   heads) on a surface-like grid of ~8 valid samples per ray: 3 warm-up
   and 10 timed steps at each of stages 1, 2 and 3 through
   make_distill_step, then a profile of one stage-3 step.
   Each path's launch counters are zeroed just before it and read just
   after; every kernel of the path must have launched.
4. Holds each kernel against its plain PyTorch version on inputs taken from
   those paths, and times both (CUDA events, median after warm-up); holds
   one distill step on the GPU against the same step on the CPU (plain) at
   test sizes; and checks that 10 stage-3 steps on a fixed batch lower the
   loss.
5. Trains a full-width hash teacher through `Trainer.train` (the quality
   recipe: the synthetic scene with 100 training views at 96x96, PVDConfig
   defaults except grid_size 64, 3000 steps: 256 padded warm-up steps,
   then the compacted path), renders the 3 test views with the eval
   renderer and fails below 25 dB test PSNR.  Then holds K7 (table
   gradient), K8 and K9 (padded composite) against their plain versions on
   inputs from that run, profiles one padded and one compacted teacher
   step, and holds one small teacher step (padded and compacted) on the
   GPU against the CPU plain step.
6. Prints the GPU's name and power limit, a {"kernels": [...]} line, and
   ends with {"ok": true, "device": {...}}.

Exits non-zero, printing no result, if any phase fails or no GPU is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from pvd_tpu_torch import kernels
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.poses import pose_spherical
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.optim import (build_optimizer, cosine_schedule,
                                        exp_decay_schedule)
from pvd_tpu_torch.engine.train_steps import (TrainState, chunk_rays,
                                              make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step)
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.models.hash_field import grid_spec
from pvd_tpu_torch.models.vm_field import normalize
from pvd_tpu_torch.ops.aabb import near_far_from_aabb
from pvd_tpu_torch.ops.composite import (composite_rays, composite_rays_bwd,
                                         composite_rays_bwd_plain,
                                         composite_rays_compact,
                                         composite_rays_compact_bwd,
                                         composite_rays_compact_fwd,
                                         composite_rays_compact_plain,
                                         composite_rays_fwd,
                                         composite_rays_plain)
from pvd_tpu_torch.ops.fma import fma32
from pvd_tpu_torch.ops.hashgrid import (hash_encode, hash_encode_bwd,
                                        hash_encode_bwd_plain,
                                        hash_encode_plain, level_corners)
from pvd_tpu_torch.ops.rays import get_rays, nerf_matrix_to_ngp
from pvd_tpu_torch.ops.vm_sample import (vm_sample_bwd, vm_sample_bwd_plain,
                                         vm_sample_fwd, vm_sample_plain)
from pvd_tpu_torch.params import (hash_field_from_jax, hash_tree_from_field,
                                  vm_field_from_jax, vm_tree_from_field)
from pvd_tpu_torch.utils.metrics import PSNRMeter
from pvd_tpu_torch.render.occupancy import (grid_coords, init_occupancy_state,
                                            query_points, set_bitfield)
from pvd_tpu_torch.render.renderer import (compact_samples, dt_min_of,
                                           march_rays, march_rays_plain,
                                           render_rays)

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores; the bounds below are the larger of bytes/BW and ops/F32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RES, CHUNK = 800, 4096
OUR_KERNELS = ("hash_encode_fwd_kernel", "march_rays_kernel",
               "segment_bounds_kernel", "composite_kernel",
               "vm_sample_fwd_kernel", "vm_sample_bwd_kernel",
               "composite_bwd_kernel", "hash_encode_bwd_kernel",
               "composite_padded_fwd_kernel", "composite_padded_bwd_kernel")
TOL_K1, TOL_K2_DD, TOL_K3 = 1e-5, 1e-6, 1e-5
# K4: the same f32 ops; K5: fp32 atomics add in a varying order, so each
# gradient leaf is held to 1e-4 of its max |g|; K6: the closed form against
# autograd through the plain composite
TOL_K4, TOL_K5_REL, TOL_K6 = 1e-5, 1e-4, 1e-5
SERVE_KERNELS = ("hash_encode", "march_rays", "composite_rays_compact")
DISTILL_KERNELS = {1: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd"),
                   2: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd"),
                   3: ("hash_encode", "march_rays", "vm_sample_fwd",
                       "vm_sample_bwd", "composite_rays_compact",
                       "composite_rays_compact_bwd")}
WARMUP_STEPS, TIMED_STEPS, FIXED_BATCH_STEPS = 3, 10, 10
# distill step at test sizes, kernels on the GPU against plain on the CPU
# (the sizes and tolerances of tests/test_torch_distill.py)
SMALL_TEA = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
                 compute_dtype="float32")
SMALL_STU = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
                 vm_resolution=(20, 24, 28), compute_dtype="float32")
SMALL_CFG = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
                 samples_per_ray=8.0, precision="fp32")
SMALL_HW, SMALL_INTR = 48, (40.0, 40.0, 24.0, 24.0)
STEP_LOSS_RTOL, STEP_GRAD_REL_ATOL, STEP_GRAD_RTOL = 2e-5, 2e-5, 1e-4
STEP_PARAM_TOL, STEP_MASK_FRAC = 1e-6, 1e-3
# end-to-end image and depth, kernel path on the GPU vs plain path on the
# CPU: the same samples (K2 is exact), f32 heads summed in other orders
E2E_RES, E2E_CHUNK, TOL_E2E = 64, 1024, 1e-4
# the teacher recipe of the repo's quality A/B (tools/quality_ab.py): 100
# training views at 96x96, grid 64, 3000 steps; the JAX package's run of
# it reached ~31.5 dB test PSNR
RECIPE = dict(n_train=100, n_val=0, n_test=3, H=96, W=96, grid_size=64,
              iters=3000)
PSNR_FLOOR = 25.0
TEACHER_KERNELS = ("hash_encode", "march_rays", "composite_rays_compact",
                   "composite_rays_compact_bwd", "hash_encode_bwd",
                   "composite_rays", "composite_rays_bwd")
# K7: fp32 atomics add in a varying order, so the gradient is held to 1e-4
# of its max |g|; K8: the same f32 ops as the plain cumprod, other order;
# K9: the closed form against autograd through the plain composite
TOL_K7_REL, TOL_K8, TOL_K9 = 1e-4, 1e-5, 1e-5
# teacher step at test sizes (tests/test_torch_teacher.py's), GPU vs CPU
SMALL_TEACHER_CFG = dict(num_rays=256, grid_size=32, max_steps=128,
                         max_samples=32, precision="fp32")


def object_like_bitfield(H: int) -> np.ndarray:
    """Deterministic 3.18% occupancy clustered like a trained object grid:
    a thick spherical shell plus a few solid blobs near the center."""
    g = np.zeros((H, H, H), bool)
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X**2 + Y**2 + Z**2)
    g |= (r > 0.42) & (r < 0.5)  # shell
    rng = np.random.default_rng(7)
    for _ in range(6):  # interior blobs
        c = rng.uniform(-0.3, 0.3, 3)
        rad = rng.uniform(0.08, 0.16)
        g |= ((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) < rad**2
    return g.reshape(-1)


def surface_bitfield(H: int) -> np.ndarray:
    """Deterministic surface-like occupancy: a thin spherical shell (radius
    0.4, ~1 cell thick) and two thin blob shells, 0.27% of cells.  A
    train-mode march from the test orbit takes ~8 valid samples per ray,
    about the batch mean of a trained grid (the reference's 16 samples per
    ray of budget is ~2x that)."""
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = np.abs(np.sqrt(X**2 + Y**2 + Z**2) - 0.4) < 0.005
    rng = np.random.default_rng(7)
    for _ in range(2):
        c = rng.uniform(-0.25, 0.25, 3)
        rad = rng.uniform(0.06, 0.12)
        r = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
        g |= np.abs(r - rad) < 0.005
    return g.reshape(-1)


def random_hash_params(spec, rng: np.random.Generator) -> dict:
    """Seeded params in the JAX package's layout.  The table is drawn from
    U(-0.5, 0.5): the reference's +-1e-4 init would make every level's
    features near-equal and hide indexing faults."""
    gs = grid_spec(spec)

    def mlp(dims):
        return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                 / np.float32(math.sqrt(i))}
                for i, o in zip(dims[:-1], dims[1:])]

    return {
        "encoder": rng.uniform(-0.5, 0.5, (gs.table_size, 2))
        .astype(np.float32),
        "sigma_net": mlp([gs.output_dim, spec.hidden_dim,
                          1 + spec.geo_feat_dim]),
        "color_net": mlp([spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                          spec.hidden_dim_color, spec.hidden_dim_color, 3]),
    }


def random_vm_params(spec, rng: np.random.Generator) -> dict:
    """Seeded VM params in the JAX package's layout and init
    (vm_field.py:41-69): planes and lines normal with scale 0.1, basis and
    color_net uniform with bound 1/sqrt(fan_in)."""
    res = spec.vm_resolution
    mats, vecs = ((0, 1), (0, 2), (1, 2)), (2, 1, 0)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape, np.float32))

    def lin(i, o):
        return {"w": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                / np.float32(math.sqrt(i))}

    tree = {}
    for rank, name in ((spec.vm_sigma_rank, "sigma"),
                       (spec.vm_color_rank, "color")):
        tree[f"{name}_mat"] = [normal(res[m1], res[m0], rank)
                               for m0, m1 in mats]
        tree[f"{name}_vec"] = [normal(res[v], rank) for v in vecs]
    tree["basis_mat"] = lin(3 * spec.vm_color_rank, spec.geo_feat_dim)
    dims = [spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
            spec.hidden_dim_color, spec.hidden_dim_color, 3]
    tree["color_net"] = [lin(i, o) for i, o in zip(dims[:-1], dims[1:])]
    return tree


def cuda_ms(fn, reps: int = 20, warmup: int = 3,
            queue_ahead: bool = True) -> float:
    """Median time of fn() in ms between CUDA events (one pair per call).

    queue_ahead=True first queues a ~0.5 ms spin kernel, so the host has
    enqueued all of fn's launches before the start event runs: the result
    is device time only.  queue_ahead=False times the call as a caller
    sees it on an idle card, the wrapper's host work included.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if queue_ahead:
            torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timings(kernel_fn, plain_fn) -> dict:
    """Kernel device time, the wrapper call as a caller sees it, and the
    plain version's time."""
    return {"ms": cuda_ms(kernel_fn),
            "call_ms": cuda_ms(kernel_fn, queue_ahead=False),
            "plain_ms": cuda_ms(plain_fn, reps=10)}


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


COUNTED = {"hash_encode": hash_encode, "march_rays": march_rays,
           "composite_rays_compact": composite_rays_compact,
           "vm_sample_fwd": vm_sample_fwd, "vm_sample_bwd": vm_sample_bwd,
           "composite_rays_compact_bwd": composite_rays_compact_bwd,
           "hash_encode_bwd": hash_encode_bwd,
           "composite_rays": composite_rays,
           "composite_rays_bwd": composite_rays_bwd}


def counters() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_counters():
    for fn in COUNTED.values():
        fn.launches = 0


def log(msg: str):
    print(msg, flush=True)


def profile(fn, top: int = 12) -> dict:
    """Device time by kernel over one call of fn (torch.profiler), and the
    device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy/memset): the CPU-side
        # aten ops carry their kernels' time too and would count it twice
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    ours = {}
    for ms, n, key in rows:
        bare = key[len("void "):] if key.startswith("void ") else key
        for name in OUR_KERNELS:
            # templated kernels (one instance per VM branch) sum up
            if bare.startswith(name + "(") or bare.startswith(name + "<"):
                row = ours.setdefault(name, {"ms": 0.0, "calls": 0})
                row["ms"] += ms
                row["calls"] += n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "ours": ours,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for ms, n, k in rows[:top]]}


def distill_setup(cfg, teacher, dev, rng, H: int):
    """The full-width student, its optimizer and state on the surface
    grid."""
    spec_stu = cfg.model_spec("vm")
    student = vm_field_from_jax(random_vm_params(spec_stu, rng), spec_stu,
                                dev)
    occ = set_bitfield(init_occupancy_state(cfg.render_spec()),
                       torch.from_numpy(surface_bitfield(H)).to(dev))
    params = dict(student.named_parameters())
    opt = build_optimizer(params, param_group_label(spec_stu),
                          trainable_label(spec_stu, cfg.distill_mode),
                          cosine_schedule(cfg.lr, cfg.iters),
                          cosine_schedule(1e-3, cfg.iters))
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    return spec_stu, opt, state


def drive_distill(cfg, spec_stu, spec_tea, opt, state, teacher, pose, intr,
                  gen) -> dict:
    """Stages 1-3 through make_distill_step: warm-up and timed steps; the
    launches of each stage are read from the counters' growth."""
    rspec = cfg.render_spec()
    stages = {}
    for stage in (1, 2, 3):
        step = make_distill_step(spec_stu, spec_tea, rspec, opt, cfg, intr,
                                 RES, RES, stage)
        before = counters()
        for _ in range(WARMUP_STEPS):
            state, logs = step(state, teacher, state.occ, pose, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, logs = step(state, teacher, state.occ, pose, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        n = WARMUP_STEPS + TIMED_STEPS
        launched = {k: v - before[k] for k, v in counters().items()}
        logs = {k: float(v) for k, v in logs.items()}
        log(f"distill stage {stage}: {ms:.2f} ms/step, "
            f"{cfg.num_rays / ms * 1e3:,.0f} rays/s; last step's logs "
            + json.dumps({k: round(v, 6) for k, v in logs.items()}))
        log(f"  launches over {n} steps: {json.dumps(launched)}")
        if not all(math.isfinite(v) for v in logs.values()):
            raise RuntimeError(f"stage {stage}: a loss is not finite")
        if not logs["compact_frac"] <= 1.0:
            raise RuntimeError(f"stage {stage}: the budget cut samples")
        for name in DISTILL_KERNELS[stage]:
            if launched[name] < n:
                raise RuntimeError(f"stage {stage}: kernel {name} launched "
                                   f"{launched[name]} times in {n} steps")
        stages[stage] = {"ms_per_step": ms,
                         "rays_per_s": cfg.num_rays / ms * 1e3,
                         "logs": logs, "launches": launched}
    return stages


def path_inputs(cfg, spec_stu, state, pose, intr, gen):
    """One stage-3 batch's compacted samples from the path: the student's
    normalized positions xn [M, 3] and its composite inputs."""
    rspec = cfg.render_spec()
    dev = pose.device
    inds = torch.randint(0, RES * RES, (cfg.num_rays,), generator=gen,
                         device=dev)
    rays = get_rays(pose[None], intr, RES, RES, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    aabb = state.occ.aabb_train
    with torch.no_grad():
        out = render_rays(state.field, spec_stu, rspec, state.occ, o, d,
                          training=True, u=u, composite=False)
        c = out["compact"]
        rid = c.ray_id
        xyz = fma32(out["compact_t"][:, None], d[rid], o[rid]).clamp(
            -rspec.bound, rspec.bound)
        f = state.field(xyz, d[rid], aabb)
    dt_c = torch.where(c.valid, dt_min_of(rspec), 0.0)
    t_cum = torch.where(c.valid, out["compact_t"] + dt_c
                        - out["samples"].t0[rid], 0.0)
    comp = (f.sigma.contiguous(), f.rgb.contiguous(), dt_c, t_cum, rid,
            c.valid, cfg.num_rays)
    return normalize(xyz, aabb).contiguous(), c, comp


def check_vm_kernels(state, xn, compact, gen) -> list:
    """K4 and K5 against their plain versions on the path's samples."""
    import torch.nn.functional as F

    planes = [p.detach() for p in state.field.planes]
    lines = [v.detach() for v in state.field.lines]
    M, R = xn.shape[0], planes[0].shape[-1]
    k4 = vm_sample_fwd(planes, lines, xn)
    p4 = vm_sample_plain(planes, lines, xn)
    err4 = max_abs(k4, p4)
    # the path's upstream gradient is zero on the invalid tail
    g = torch.randn(3, M, R, generator=gen, device=xn.device) \
        * compact.valid[None, :, None]
    k5 = vm_sample_bwd(planes, lines, xn, g)
    p5 = vm_sample_bwd_plain(planes, lines, xn, g)
    err5 = max(max_abs(a, b) / float(b.abs().max())
               for a, b in zip(k5[0] + k5[1], p5[0] + p5[1]))
    abs5 = max(max_abs(a, b) for a, b in zip(k5[0] + k5[1], p5[0] + p5[1]))
    # bytes: xn once, each touched plane row and line row once, outputs once
    touched = 0
    for i, (m0, m1) in enumerate(((0, 1), (0, 2), (1, 2))):
        Hp, Wp = planes[i].shape[:2]
        px = ((xn[:, m0] + 1) * 0.5 * (Wp - 1)).floor().clamp(0, Wp - 2)
        py = ((xn[:, m1] + 1) * 0.5 * (Hp - 1)).floor().clamp(0, Hp - 2)
        row = (py * Wp + px).long()
        rows = torch.cat([row, row + 1, row + Wp, row + Wp + 1]).unique()
        touched += rows.numel() + lines[i].shape[0]
    n_valid = int(compact.valid.sum())
    b4 = bound(M * 12 + touched * R * 4 + 3 * M * R * 4, 3 * M * R * 14)
    plane_bytes = sum(p.numel() + v.numel() for p, v in zip(planes, lines)) * 4
    b5 = bound(M * 12 + 3 * M * R * 4 + touched * R * 4 + plane_bytes,
               3 * n_valid * R * 26)
    # library yardstick: F.grid_sample (align_corners, zeros) computes the
    # plane half of K4; its backward the plane half of K5
    ims = [p.permute(2, 0, 1)[None].contiguous() for p in planes]
    grids = [xn[:, [m0, m1]][None, None].contiguous()
             for m0, m1 in ((0, 1), (0, 2), (1, 2))]

    def lib_fwd():
        return [F.grid_sample(im, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for im, gr in zip(ims, grids)]

    ims_g = [im.clone().requires_grad_() for im in ims]
    g_lib = [torch.randn(1, R, 1, M, generator=gen, device=xn.device)
             for _ in range(3)]

    def lib_bwd():
        outs = [F.grid_sample(im, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for im, gr in zip(ims_g, grids)]
        return torch.autograd.grad(outs, ims_g, g_lib)

    return [
        dict(name="vm_sample_fwd", source="pvd_tpu_torch/csrc/vm_sample.cu",
             replaces="pvd_tpu/models/vm_field.py:160", err=err4,
             tol=TOL_K4,
             **timings(lambda: vm_sample_fwd(planes, lines, xn),
                       lambda: vm_sample_plain(planes, lines, xn)),
             library_ms=cuda_ms(lib_fwd),
             library_call="F.grid_sample x3 planes (the plane half of K4)",
             bound=b4, shape=f"M={M} samples x 3 branches x R={R}"),
        dict(name="vm_sample_bwd", source="pvd_tpu_torch/csrc/vm_sample.cu",
             replaces="pvd_tpu/models/vm_field.py:173", err=err5,
             abs_err=abs5,
             tol=TOL_K5_REL, err_kind="max |kernel - plain| / max |plain| "
             "per gradient leaf",
             **timings(lambda: vm_sample_bwd(planes, lines, xn, g),
                       lambda: vm_sample_bwd_plain(planes, lines, xn, g)),
             library_ms=cuda_ms(lib_bwd),
             library_call="F.grid_sample fwd+bwd x3 planes (the plane half "
             "of K5)",
             bound=b5, shape=f"M={M} samples ({n_valid} valid) x 3 branches "
             f"x R={R}")]


def check_composite_bwd(comp, gen) -> dict:
    """K6 against autograd through the plain composite, on the path's
    stream, with random upstream gradients of all four outputs."""
    sig, rgb, dt_c, t_cum, rid, valid, N = comp
    M = sig.shape[0]
    dev = sig.device
    gs = (torch.randn(N, generator=gen, device=dev),
          torch.randn(N, generator=gen, device=dev),
          torch.randn(N, 3, generator=gen, device=dev),
          torch.randn(M, generator=gen, device=dev))

    def grads_of(fn):
        s = sig.detach().clone().requires_grad_()
        r = rgb.detach().clone().requires_grad_()
        outs = fn(s, r, dt_c, t_cum, rid, valid, N)
        return torch.autograd.grad(outs, (s, r), gs)

    k6 = grads_of(composite_rays_compact)
    p6 = grads_of(composite_rays_compact_plain)
    err6 = max(max_abs(a, b) for a, b in zip(k6, p6))
    _, _, _, weights, bounds = composite_rays_compact_fwd(
        sig, rgb, dt_c, t_cum, rid, valid, N)
    s_p = sig.detach().clone().requires_grad_()
    r_p = rgb.detach().clone().requires_grad_()
    outs_p = composite_rays_compact_plain(s_p, r_p, dt_c, t_cum, rid, valid,
                                          N)
    n_valid = int(valid.sum())
    b6 = bound(n_valid * (4 + 12 + 4 + 4 + 4) + N * (8 + 4 + 4 + 12)
               + n_valid * 4 + M * 16, n_valid * 30)
    return dict(
        name="composite_rays_compact_bwd",
        source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:28", err=err6, tol=TOL_K6,
        **timings(lambda: composite_rays_compact_bwd(
            sig, rgb, dt_c, t_cum, weights, bounds, *gs),
            lambda: torch.autograd.grad(outs_p, (s_p, r_p), gs,
                                        retain_graph=True)),
        library_ms=None, bound=b6,
        shape=f"M={M} slots ({n_valid} valid), N={N} rays")


def tree_leaves(tree) -> list:
    """The arrays of a VM params tree, in sorted key order."""
    out = []
    for k in sorted(tree):
        for x in (tree[k] if isinstance(tree[k], list) else [tree[k]]):
            out.append(x["w"] if isinstance(x, dict) else x)
    return out


def small_step_gpu_vs_cpu() -> dict:
    """One stage-3 distill step at test sizes: kernels on the GPU against
    the plain path on the CPU, same params and draws."""
    rng = np.random.default_rng(11)
    cfg = PVDConfig(**SMALL_CFG)
    spec_tea, spec_stu = ModelSpec(**SMALL_TEA), ModelSpec(**SMALL_STU)
    tea_tree = random_hash_params(spec_tea, rng)
    stu_tree = random_vm_params(spec_stu, rng)
    bits = rng.uniform(size=cfg.grid_size ** 3) < 0.25
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    inds = torch.from_numpy(rng.integers(0, SMALL_HW ** 2, cfg.num_rays))
    rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR, SMALL_HW,
                    SMALL_HW, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    bg = torch.from_numpy(rng.uniform(size=(cfg.num_rays, 3))
                          .astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=cfg.num_rays).astype(np.float32))
    res = {}
    for where in ("cuda", "cpu"):
        teacher = hash_field_from_jax(tea_tree, spec_tea, where)
        student = vm_field_from_jax(stu_tree, spec_stu, where)
        occ = set_bitfield(init_occupancy_state(cfg.render_spec(), where),
                           torch.from_numpy(bits).to(where))
        params = dict(student.named_parameters())
        opt = build_optimizer(params, param_group_label(spec_stu),
                              trainable_label(spec_stu, ""),
                              cosine_schedule(1e-2, 100),
                              cosine_schedule(1e-3, 100))
        state = TrainState(field=student, opt_state=opt.init(params),
                           occ=occ)
        step = make_distill_step(spec_stu, spec_tea, cfg.render_spec(), opt,
                                 cfg, SMALL_INTR, SMALL_HW, SMALL_HW, 3,
                                 device=where)
        state, logs = step.core(state, teacher, occ, *(
            t.to(where) for t in (o, d, bg, u)))
        res[where] = ({k: float(v) for k, v in logs.items()},
                      vm_tree_from_field(student, grad=True),
                      vm_tree_from_field(student))
    (lg, gg, pg), (lc, gc, pc) = res["cuda"], res["cpu"]
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    grad_err = param_err = 0.0
    grad_ok = True
    for a, b, pa, pb in zip(tree_leaves(gg), tree_leaves(gc),
                            tree_leaves(pg), tree_leaves(pc)):
        scale = float(np.abs(b).max())
        grad_err = max(grad_err, float(np.abs(a - b).max())
                       / max(scale, 1e-30))
        grad_ok &= bool(np.all(np.abs(a - b) <= STEP_GRAD_REL_ATOL * scale
                               + STEP_GRAD_RTOL * np.abs(b)))
        # Adam's first step is lr * sign(g): hold params where g is clear
        # of rounding noise, or exactly 0 (weight decay alone)
        hold = (np.abs(b) > STEP_MASK_FRAC * scale) | (b == 0)
        param_err = max(param_err, float(np.abs(pa - pb)[hold].max()))
    param_ok = param_err <= STEP_PARAM_TOL
    log(f"distill step GPU kernels vs CPU plain (test sizes, stage 3, f32 "
        f"heads): max rel loss/log diff {loss_err:.3g} (tol "
        f"{STEP_LOSS_RTOL:g}); max grad diff / leaf max {grad_err:.3g} "
        f"(tol {STEP_GRAD_REL_ATOL:g} + rtol {STEP_GRAD_RTOL:g}); max param "
        f"diff under the gradient mask {param_err:.3g} (tol "
        f"{STEP_PARAM_TOL:g}); loss {lc['loss']:.6g}, compact_frac "
        f"{lc['compact_frac']:.3f}")
    if not (loss_err <= STEP_LOSS_RTOL and grad_ok and param_ok):
        raise RuntimeError("the GPU distill step disagrees with the CPU "
                           "plain step")
    return {"loss_rel_err": loss_err, "grad_err_rel_leaf_max": grad_err,
            "param_err": param_err}


def fixed_batch_descent(cfg, spec_stu, spec_tea, opt, state, teacher, pose,
                        intr, gen) -> list:
    """Stage-3 steps on one fixed batch (same o, d, bg, u) must lower the
    loss."""
    dev = pose.device
    inds = torch.randint(0, RES * RES, (cfg.num_rays,), generator=gen,
                         device=dev)
    rays = get_rays(pose[None], intr, RES, RES, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    bg = torch.rand(cfg.num_rays, 3, generator=gen, device=dev)
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    step = make_distill_step(spec_stu, spec_tea, cfg.render_spec(), opt,
                             cfg, intr, RES, RES, 3)
    losses = []
    for _ in range(FIXED_BATCH_STEPS):
        state, logs = step.core(state, teacher, state.occ, o, d, bg, u)
        losses.append(float(logs["loss"]))
    log(f"fixed batch, {FIXED_BATCH_STEPS} stage-3 steps: loss "
        + " ".join(f"{v:.6g}" for v in losses))
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise RuntimeError("stage-3 steps on a fixed batch did not lower "
                           "the loss")
    return losses


def drive_teacher(seed: int) -> tuple:
    """The recipe through Trainer.train, then the test views through the
    trainer's eval renderer.  Returns (trainer, scene, info)."""
    cfg = PVDConfig(grid_size=RECIPE["grid_size"], iters=RECIPE["iters"],
                    seed=seed)
    t0 = time.perf_counter()
    scene = make_synthetic_scene(n_train=RECIPE["n_train"],
                                 n_val=RECIPE["n_val"],
                                 n_test=RECIPE["n_test"], H=RECIPE["H"],
                                 W=RECIPE["W"], seed=seed, scale=cfg.scale)
    scene_s = time.perf_counter() - t0
    trainer = Trainer(cfg)
    log(f"teacher recipe: {RECIPE['n_train']} views {RECIPE['H']}x"
        f"{RECIPE['W']} (scene made in {scene_s:.1f} s), grid "
        f"{cfg.grid_size}, {cfg.iters} steps of {cfg.num_rays} rays, "
        f"max_samples {cfg.max_samples}, samples_per_ray "
        f"{cfg.samples_per_ray:g} after the warm-up; table "
        f"{trainer.state.field.grid.table_size} rows, heads "
        f"{trainer.spec.compute_dtype}")
    trainer.train(scene["train"])
    stats = trainer.train_stats
    hist = trainer.history
    first = float(np.mean([float(m["psnr"]) for m in hist[:16]]))
    last = float(np.mean([float(m["psnr"]) for m in hist[-16:]]))
    test = scene["test"]
    meter = PSNRMeter()
    renders = []
    for pose, img in zip(test.poses, test.images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.eval_render(trainer.state.field, trainer.state.occ,
                                  pose, test.intrinsics, test.H, test.W)
        torch.cuda.synchronize()
        renders.append((time.perf_counter() - t0) * 1e3)
        gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        pred = out.image.cpu().numpy()
        if not (np.isfinite(pred).all() and pred.shape == gt.shape):
            raise RuntimeError("teacher eval render: bad image")
        meter.update(pred, gt)
    psnr = meter.measure()
    occ = trainer.state.occ
    info = {"test_psnr": psnr, "train_psnr_first16": first,
            "train_psnr_last16": last, "render_ms": renders,
            "train_stats": stats, "rspec_final": {
                "max_samples": trainer.rspec.max_samples,
                "samples_per_ray": trainer.rspec.samples_per_ray},
            "occupied": float(occ.bitfield.float().mean()),
            "last_metrics": {k: float(v) for k, v in hist[-1].items()}}
    log(f"teacher: test PSNR {psnr:.3f} dB over {len(test)} views (floor "
        f"{PSNR_FLOOR}); train-batch PSNR first 16 steps {first:.3f}, last "
        f"16 {last:.3f}; final S_max {trainer.rspec.max_samples}, budget/ray "
        f"{trainer.rspec.samples_per_ray:g}; grid occupied "
        f"{info['occupied']:.4f}; renders "
        + " ".join(f"{ms:.1f}" for ms in renders) + " ms")
    log("teacher train_stats " + json.dumps(stats))
    if not psnr >= PSNR_FLOOR:
        raise RuntimeError(f"teacher test PSNR {psnr:.3f} < {PSNR_FLOOR}")
    if not last > first:
        raise RuntimeError("teacher train-batch PSNR did not rise")
    return trainer, scene, info


def teacher_batch(trainer, scene, gen, rspec):
    """One batch of the teacher path on the trained grid: 8192 pixels of
    training view 0, marched (perturbed) with `rspec`."""
    train = scene["train"]
    dev = trainer.device
    cfg = trainer.cfg
    pose = torch.as_tensor(train.poses[0], device=dev)
    intr = tuple(float(v) for v in train.intrinsics)
    inds = torch.randint(0, train.H * train.W, (cfg.num_rays,),
                         generator=gen, device=dev)
    rays = get_rays(pose[None], intr, train.H, train.W, inds)
    o = rays["rays_o"][0].contiguous()
    d = rays["rays_d"][0].contiguous()
    occ = trainer.state.occ
    nears, fars = near_far_from_aabb(o, d, occ.aabb_train, rspec.min_near)
    u = torch.rand(cfg.num_rays, generator=gen, device=dev)
    samples = march_rays(occ.bitfield, o, d, nears, fars, rspec, u)
    return o, d, samples


def check_teacher_kernels(trainer, scene, gen) -> tuple:
    """K7 at the padded and compacted shapes, K8 (with and without early
    stop) and K9 at the padded shape, on the trained field's samples."""
    field = trainer.state.field
    gs = field.grid
    table = field.encoder.detach()
    b = trainer.rspec.bound
    dev = trainer.device
    # the warm-up's padded shape, and the compacted path's after autotune
    rs_pad = dataclasses.replace(trainer.rspec,
                                 max_samples=trainer.cfg.max_samples,
                                 samples_per_ray=0.0)
    o, d, s = teacher_batch(trainer, scene, gen, rs_pad)
    N, S = s.mask.shape
    xyz = fma32(s.t[..., None], d[:, None, :], o[:, None, :]).clamp(-b, b)
    x01_pad = ((xyz.reshape(-1, 3) + b) / (2.0 * b)).contiguous()
    g_pad = torch.randn(N * S, gs.output_dim, generator=gen, device=dev) \
        * s.mask.reshape(-1, 1)
    rs_c = trainer.rspec
    _, _, s_c = teacher_batch(trainer, scene, gen, rs_c)
    budget = rs_c.sample_budget(trainer.cfg.num_rays)
    cmp = compact_samples(s_c.mask, budget, prefix=True)
    rid = cmp.ray_id
    t_c = s_c.t.reshape(-1)[cmp.idx]
    xyz_c = fma32(t_c[:, None], d[rid], o[rid]).clamp(-b, b)
    x01_c = ((xyz_c + b) / (2.0 * b)).contiguous()
    g_c = torch.randn(budget, gs.output_dim, generator=gen, device=dev) \
        * cmp.valid[:, None]

    def k7_case(x01, g):
        k = hash_encode_bwd(x01, g, gs)
        p = hash_encode_bwd_plain(x01, g, gs)
        err_abs = max_abs(k, p)
        err = err_abs / float(p.abs().max())
        P = x01.shape[0]
        active = int((g.reshape(P, gs.num_levels, 2) != 0).any(-1).sum())
        # bytes: x01 and g read once, the dense [T, 2] gradient written once
        bnd = bound(P * 12 + P * gs.output_dim * 4 + gs.table_size * 8,
                    active * 8 * 6)
        return k, p, err, err_abs, bnd, active

    results, extra = [], {}
    k7p = k7_case(x01_pad, g_pad)
    t7p = timings(lambda: hash_encode_bwd(x01_pad, g_pad, gs),
                  lambda: hash_encode_bwd_plain(x01_pad, g_pad, gs))
    extra["hash_encode_bwd_padded"] = dict(
        err=k7p[2], abs_err=k7p[3], bound=k7p[4], active_pairs=k7p[5],
        points=x01_pad.shape[0], **t7p)
    k7c = k7_case(x01_c, g_c)
    # library yardstick: one index_add_ of the precomputed corner
    # contributions (the scatter alone, without the corner math)
    rows, vals = [], []
    for level in range(gs.num_levels):
        w, r = level_corners(x01_c, gs, level)
        rows.append(r.reshape(-1))
        vals.append((w[:, :, None] * g_c[None, :, 2 * level:2 * level + 2])
                    .reshape(-1, 2))
    rows, vals = torch.cat(rows), torch.cat(vals)

    def lib7():
        return torch.zeros(gs.table_size, 2, device=dev).index_add_(
            0, rows, vals)

    results.append(dict(
        name="hash_encode_bwd", source="pvd_tpu_torch/csrc/hash_encode.cu",
        replaces="pvd_tpu/ops/hashgrid.py:284", err=k7c[2], abs_err=k7c[3],
        tol=TOL_K7_REL, err_kind="max |kernel - plain| / max |plain|",
        **timings(lambda: hash_encode_bwd(x01_c, g_c, gs),
                  lambda: hash_encode_bwd_plain(x01_c, g_c, gs)),
        library_ms=cuda_ms(lib7),
        library_call="index_add_ of the precomputed corner contributions "
        "(scatter only)", bound=k7c[4],
        shape=f"M={budget} compacted points ({int(cmp.valid.sum())} valid, "
        f"{k7c[5]} active (point, level) pairs) x {gs.num_levels} levels"))
    del rows, vals
    log(f"K7 padded shape: {x01_pad.shape[0]} points, {k7p[5]} active "
        f"pairs: rel err {k7p[2]:.3g}, kernel {t7p['ms']:.4f} ms (call "
        f"{t7p['call_ms']:.4f}), plain {t7p['plain_ms']:.4f} ms, bound "
        f"{k7p[4][0]:.4f} ms ({k7p[4][1]})")

    # K8 / K9 on the trained field's padded samples
    with torch.no_grad():
        f = field(xyz.reshape(-1, 3), d[:, None, :].expand(N, S, 3)
                  .reshape(-1, 3))
    sig = (f.sigma.reshape(N, S) * rs_pad.density_scale).contiguous()
    rgb = f.rgb.reshape(N, S, 3).contiguous()
    args8 = (sig, rgb, s.dt, s.delta_depth, s.mask)
    err8 = 0.0
    for early in (False, True):
        k8 = composite_rays_fwd(*args8, early_stop=early)
        p8 = composite_rays_plain(*args8, early_stop=early)
        err8 = max(err8, max(max_abs(a, c) for a, c in zip(k8, p8)))
    n_valid = int(s.mask.sum())
    ws = k8[0]
    log(f"K8/K9 block: [{N}, {S}], {n_valid} valid slots (mask_frac "
        f"{n_valid / (N * S):.4f}), weights_sum mean {float(ws.mean()):.4f}")
    b8 = bound(N * S * 25 + N * S * 4 + N * 20, N * S * 16)
    results.append(dict(
        name="composite_rays", source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:97", err=err8, tol=TOL_K8,
        **timings(lambda: composite_rays_fwd(*args8),
                  lambda: composite_rays_plain(*args8)),
        library_ms=None, bound=b8,
        shape=f"[{N}, {S}] padded slots ({n_valid} valid), early_stop "
        "off and on"))
    gs9 = (torch.randn(N, generator=gen, device=dev),
           torch.randn(N, generator=gen, device=dev),
           torch.randn(N, 3, generator=gen, device=dev),
           torch.randn(N, S, generator=gen, device=dev))
    weights = composite_rays_fwd(*args8)[3]
    k9 = composite_rays_bwd(*args8, weights, *gs9)
    p9 = composite_rays_bwd_plain(*args8, *gs9)
    err9 = max(max_abs(a, c) for a, c in zip(k9, p9))
    b9 = bound(N * S * 29 + N * 20 + N * S * 4 + N * S * 16, N * S * 30)
    results.append(dict(
        name="composite_rays_bwd", source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:97", err=err9, tol=TOL_K9,
        **timings(lambda: composite_rays_bwd(*args8, weights, *gs9),
                  lambda: composite_rays_bwd_plain(*args8, *gs9)),
        library_ms=None, bound=b9,
        shape=f"[{N}, {S}] padded slots ({n_valid} valid)"))
    return results, extra


def teacher_step_flavors(trainer, scene) -> dict:
    """Launches of one teacher step and a profile of one step, for the
    padded (warm-up) and the compacted flavor, on the trained state."""
    train = scene["train"]
    out = {}
    images = torch.as_tensor(train.images_flat(), device=trainer.device)
    poses = torch.as_tensor(train.poses, device=trainer.device)
    flavors = {"padded": dataclasses.replace(
        trainer.rspec, max_samples=trainer.cfg.max_samples,
        samples_per_ray=0.0), "compacted": trainer.rspec}
    for name, rs in flavors.items():
        step = make_teacher_step(trainer.spec, rs, trainer.opt, trainer.cfg,
                                 train.intrinsics, train.H, train.W,
                                 image_channels=4, device=trainer.device)
        for i in range(3):  # warm-up
            step(trainer.state, poses[i], images[i], trainer.generator)
        torch.cuda.synchronize()
        reset_counters()
        step(trainer.state, poses[3], images[3], trainer.generator)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counters().items() if v}
        prof = profile(lambda: step(trainer.state, poses[4], images[4],
                                    trainer.generator))
        log(f"teacher {name} step: launches {json.dumps(launched)}; profile "
            f"wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms (share "
            f"{prof['device_busy_share']:.3f})")
        for row in prof["top"]:
            log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
        for kname, row in prof["ours"].items():
            log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {kname}")
        out[name] = {"launches_per_step": launched, "profile": prof}
    return out


def small_teacher_gpu_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """One teacher step at test sizes, padded and compacted: kernels on
    the GPU against the plain path on the CPU, same params and draws."""
    rng = np.random.default_rng(12)
    spec = ModelSpec(**SMALL_TEA)
    tree = random_hash_params(spec, rng)
    bits = rng.uniform(size=32 ** 3) < 0.25
    image = rng.uniform(size=(SMALL_HW ** 2, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=SMALL_HW ** 2)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    n = SMALL_TEACHER_CFG["num_rays"]
    inds = torch.from_numpy(rng.integers(0, SMALL_HW ** 2, n))
    rays = get_rays(torch.from_numpy(pose)[None], SMALL_INTR, SMALL_HW,
                    SMALL_HW, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    pix = torch.from_numpy(image)[inds]
    bg = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    report = {}
    for spr in (0.0, 16.0):
        cfg = PVDConfig(**SMALL_TEACHER_CFG, samples_per_ray=spr)
        res = []
        for where in devices:
            field = hash_field_from_jax(tree, spec, where)
            occ = set_bitfield(init_occupancy_state(cfg.render_spec(), where),
                               torch.from_numpy(bits).to(where))
            params = dict(field.named_parameters())
            opt = build_optimizer(params, param_group_label(spec),
                                  trainable_label(spec, ""),
                                  exp_decay_schedule(1e-2, 100),
                                  exp_decay_schedule(1e-3, 100))
            state = TrainState(field=field, opt_state=opt.init(params),
                               occ=occ)
            step = make_teacher_step(spec, cfg.render_spec(), opt, cfg,
                                     SMALL_INTR, SMALL_HW, SMALL_HW, 4,
                                     device=where)
            state, m = step.core(state, *(t.to(where)
                                          for t in (o, d, pix, bg, u)))
            res.append(({k: float(v) for k, v in m.items()},
                        hash_tree_from_field(field, grad=True),
                        hash_tree_from_field(field)))
        (lg, gg, pg), (lc, gc, pc) = res
        loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)
                       for k in lc)
        grad_err = param_err = 0.0
        grad_ok = True
        for a, b, pa, pb in zip(tree_leaves(gg), tree_leaves(gc),
                                tree_leaves(pg), tree_leaves(pc)):
            scale = float(np.abs(b).max())
            grad_err = max(grad_err, float(np.abs(a - b).max())
                           / max(scale, 1e-30))
            grad_ok &= bool(np.all(np.abs(a - b) <= STEP_GRAD_REL_ATOL
                                   * scale + STEP_GRAD_RTOL * np.abs(b)))
            hold = (np.abs(b) > STEP_MASK_FRAC * scale) | (b == 0)
            param_err = max(param_err, float(np.abs(pa - pb)[hold].max()))
        flavor = "compacted" if spr else "padded"
        log(f"teacher step GPU kernels vs CPU plain (test sizes, {flavor}, "
            f"f32 heads): max rel loss/metric diff {loss_err:.3g} (tol "
            f"{STEP_LOSS_RTOL:g}); max grad diff / leaf max {grad_err:.3g} "
            f"(tol {STEP_GRAD_REL_ATOL:g} + rtol {STEP_GRAD_RTOL:g}); max "
            f"param diff under the gradient mask {param_err:.3g} (tol "
            f"{STEP_PARAM_TOL:g}); loss {lc['loss']:.6g}, mask_frac "
            f"{lc['mask_frac']:.3f}")
        if not (loss_err <= STEP_LOSS_RTOL and grad_ok
                and param_err <= STEP_PARAM_TOL):
            raise RuntimeError(f"the GPU teacher step ({flavor}) disagrees "
                               "with the CPU plain step")
        report[flavor] = {"loss_rel_err": loss_err,
                          "grad_err_rel_leaf_max": grad_err,
                          "param_err": param_err}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # ---- set-up -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    build_s = kernels.build_seconds()
    log(f"kernel build+load: {build_s:.1f} s ({kernels.library_path().name})")
    for line in (kernels.library_path().parent
                 / (kernels.library_path().name + ".log")).read_text() \
            .splitlines():
        if "registers" in line or line.startswith("=="):
            log("  ptxas " + line.strip())

    cfg = PVDConfig()
    spec, rspec = cfg.model_spec(), cfg.render_spec()
    H, C = rspec.grid_size, rspec.cascades
    rng = np.random.default_rng(args.seed)
    tree = random_hash_params(spec, rng)
    field = hash_field_from_jax(tree, spec, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    jitter = torch.rand((C, H ** 3, 3), generator=gen, device=dev)
    occ_update = make_occ_update(spec, rspec)
    renderer = make_eval_renderer(spec, rspec, chunk=CHUNK)
    focal = 0.5 * RES / math.tan(0.5 * 0.6911112070083618)
    intr = (focal, focal, RES / 2.0, RES / 2.0)
    intr_e2e = tuple(v * E2E_RES / RES for v in intr)
    poses = [nerf_matrix_to_ngp(pose_spherical(th, -30.0, 4.0))
             for th in (0.0, 120.0, 240.0)]
    log(f"model: hash {spec.hash_num_levels}x{spec.hash_level_dim} "
        f"table {field.grid.table_size} rows, heads {spec.compute_dtype}; "
        f"grid {H}^3 x {C}, max_steps {rspec.max_steps}, samples_per_ray "
        f"{rspec.samples_per_ray:g}, chunk {CHUNK}")

    # ---- main path: occupancy sweep + three renders --------------------
    reset_counters()
    occ = init_occupancy_state(rspec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = occ_update(occ, field, full=True, jitter=jitter)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    log(f"occupancy sweep: {C * H ** 3} density queries, {sweep_ms:.1f} ms, "
        f"occupied {float(occ.bitfield.float().mean()):.4f}, mean density "
        f"{float(occ.mean_density):.4f}")
    # random weights make no object: march the object grid instead
    occ = set_bitfield(occ, torch.from_numpy(object_like_bitfield(H)).to(dev))
    log(f"object grid: occupied {float(occ.bitfield.float().mean()):.4f}")
    images = []
    for i, pose in enumerate(poses):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer(field, occ, pose, intr, RES, RES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(out.image).all()
                      and torch.isfinite(out.depth).all())
        ws_ok = bool((out.weights_sum >= 0).all()
                     and (out.weights_sum <= 1 + 1e-5).all())
        hit = float((out.weights_sum > 0.01).float().mean())
        spr = out.samples / (RES * RES)
        log(f"render {i}: {RES}x{RES} {ms:.1f} ms, rungs {out.rungs}, "
            f"truncated chunks {out.truncated_chunks}, samples/ray "
            f"{spr:.3f}, finite {finite}, weights_sum in [0,1] {ws_ok}, "
            f"rays with weights_sum>0.01 {hit:.4f}")
        if not (finite and ws_ok and out.image.shape == (RES, RES, 3)):
            raise RuntimeError(f"render {i}: bad image")
        if not 0.0 < hit < 1.0:
            raise RuntimeError(f"render {i}: object not seen ({hit})")
        images.append({"ms": ms, "rungs": out.rungs, "samples_per_ray": spr})
    launches = {k: v for k, v in counters().items() if k in SERVE_KERNELS}
    log(f"launches on the serving path: {json.dumps(launches)}")
    n_chunks = -(-RES * RES // CHUNK)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the path")
    if launches["march_rays"] < n_chunks * len(poses):
        raise RuntimeError(f"march_rays launched {launches['march_rays']} "
                           f"times, expected >= {n_chunks} per image")

    # where one render's time goes (after the counted path)
    prof = profile(lambda: renderer(field, occ, poses[1], intr, RES, RES))
    log(f"profile of render 1: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms "
        f"(share {prof['device_busy_share']:.3f})")
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    for name, row in prof["ours"].items():
        log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {name}")

    # ---- main path 2: the distill step, stages 1-3 ---------------------
    spec_stu, opt, state = distill_setup(cfg, field, dev, rng, H)
    pose_t = torch.as_tensor(poses[0], device=dev)
    log(f"distill: student vm {spec_stu.vm_resolution} ranks "
        f"{spec_stu.vm_sigma_rank}/{spec_stu.vm_color_rank} "
        f"({sum(p.numel() for p in state.field.parameters()):,} params), "
        f"teacher the hash field above (frozen); {cfg.num_rays} rays, "
        f"budget {rspec.sample_budget(cfg.num_rays)}, surface grid occupied "
        f"{float(state.occ.bitfield.float().mean()):.4f}")
    reset_counters()
    stages = drive_distill(cfg, spec_stu, spec, opt, state, field, pose_t,
                           intr, gen)
    distill_launches = counters()
    n_steps = 3 * (WARMUP_STEPS + TIMED_STEPS)
    log(f"launches on the distill path ({n_steps} steps): "
        f"{json.dumps(distill_launches)}")
    step3 = make_distill_step(spec_stu, spec, rspec, opt, cfg, intr, RES,
                              RES, 3)
    prof_d = profile(lambda: step3(state, field, state.occ, pose_t, gen))
    log(f"profile of one stage-3 step: wall {prof_d['wall_ms']:.2f} ms, "
        f"device busy {prof_d['device_busy_ms']:.2f} ms (share "
        f"{prof_d['device_busy_share']:.3f})")
    for row in prof_d["top"]:
        log(f"  {row['ms']:9.3f} ms {row['calls']:6d} x {row['kernel']}")
    for name, row in prof_d["ours"].items():
        log(f"  ours: {row['ms']:9.3f} ms {row['calls']:6d} x {name}")

    # ---- kernels vs their plain versions --------------------------------
    results = []
    # K1 on the sweep's query points
    pts = query_points(grid_coords(H, dev), 0, jitter[0], rspec)
    x01 = ((pts + rspec.bound) / (2.0 * rspec.bound)).contiguous()
    table, gs = field.encoder.detach(), field.grid
    k1 = hash_encode(table, x01, gs)
    p1 = hash_encode_plain(table, x01, gs)
    err1 = max_abs(k1, p1)
    n1 = x01.shape[0]
    b1 = bound(n1 * 12 + n1 * gs.output_dim * 4
               + min(gs.table_size, n1 * gs.num_levels * 8) * 8,
               n1 * gs.num_levels * 50)
    results.append(dict(
        name="hash_encode", source="pvd_tpu_torch/csrc/hash_encode.cu",
        replaces="pvd_tpu/ops/hashgrid.py:533", err=err1, tol=TOL_K1,
        **timings(lambda: hash_encode(table, x01, gs),
                  lambda: hash_encode_plain(table, x01, gs)),
        bound=b1, shape=f"N={n1} points x {gs.num_levels} levels"))

    # K2 on one chunk of render 0's rays (through the image center)
    rs_eval = dataclasses.replace(rspec, max_samples=rspec.max_steps)
    head = (RES * RES // 2) // CHUNK * CHUNK
    pose0 = torch.as_tensor(poses[0], device=dev)
    o, d = chunk_rays(pose0, intr, RES, RES, head, CHUNK)
    o, d = o.contiguous(), d.contiguous()
    nears, fars = near_far_from_aabb(o, d, occ.aabb_infer, rspec.min_near)
    bf = occ.bitfield

    def k2():
        return march_rays(bf, o, d, nears, fars, rs_eval)

    sk, sp = k2(), march_rays_plain(bf, o, d, nears, fars, rs_eval)
    exact = all(torch.equal(getattr(sk, f), getattr(sp, f))
                for f in ("t", "dt", "mask", "t0"))
    err2 = max_abs(sk.delta_depth, sp.delta_depth)
    # train mode (first max_samples occupied points) with a perturbation
    u = torch.rand(CHUNK, generator=gen, device=dev)
    tk = march_rays(bf, o, d, nears, fars, rspec, u)
    tp = march_rays_plain(bf, o, d, nears, fars, rspec, u)
    exact_train = all(torch.equal(getattr(tk, f), getattr(tp, f))
                      for f in ("t", "dt", "mask", "t0"))
    err2 = max(err2, max_abs(tk.delta_depth, tp.delta_depth))
    # two cascades (bound 2, the frexp cascade pick) on a random grid;
    # these rays start inside the box
    rs2 = dataclasses.replace(rs_eval, bound=2.0)
    bf2 = torch.rand(rs2.cascades * H ** 3, generator=gen, device=dev) < 0.1
    aabb2 = torch.tensor([-2.0] * 3 + [2.0] * 3, device=dev)
    n2, f2 = near_far_from_aabb(o, d, aabb2, rs2.min_near)
    ck = march_rays(bf2, o, d, n2, f2, rs2)
    cp = march_rays_plain(bf2, o, d, n2, f2, rs2)
    exact_c2 = all(torch.equal(getattr(ck, f), getattr(cp, f))
                   for f in ("t", "dt", "mask", "t0"))
    err2 = max(err2, max_abs(ck.delta_depth, cp.delta_depth))
    log(f"K2 t/dt/mask exact: eval {exact}, train {exact_train}, two "
        f"cascades {exact_c2}; samples: eval {int(sk.mask.sum())}, train "
        f"{int(tk.mask.sum())}, two cascades {int(ck.mask.sum())}")
    if not (exact and exact_train and exact_c2):
        raise RuntimeError("march_rays kernel differs from the plain version")
    S, L = rs_eval.max_samples, rs_eval.max_steps
    b2 = bound(CHUNK * 32 + bf.numel() + CHUNK * S * 13 + CHUNK * 4,
               CHUNK * L * 20)
    results.append(dict(
        name="march_rays", source="pvd_tpu_torch/csrc/march.cu",
        replaces="pvd_tpu/render/renderer.py:643", err=err2, tol=TOL_K2_DD,
        **timings(k2, lambda: march_rays_plain(bf, o, d, nears, fars,
                                               rs_eval)),
        bound=b2, shape=f"N={CHUNK} rays x L={L} eval slots"))

    # K3 on that chunk's compacted stream at the 1x budget
    rs_c = dataclasses.replace(rs_eval, samples_per_ray=rspec.samples_per_ray)
    budget = rs_c.sample_budget(CHUNK)
    cmp = compact_samples(sk.mask, budget, prefix=False)
    with torch.no_grad():
        t_c = sk.t.reshape(-1)[cmp.idx]
        rid = cmp.ray_id
        xyz = (o[rid] + t_c[:, None] * d[rid]).clamp(-rspec.bound,
                                                      rspec.bound)
        f_out = field(xyz, d[rid])
    dt_c = torch.where(cmp.valid, dt_min_of(rspec), 0.0)
    t_cum = torch.where(cmp.valid, t_c + dt_c - sk.t0[rid], 0.0)
    sig = f_out.sigma.contiguous()
    rgb = f_out.rgb.contiguous()
    k3args = (sig, rgb, dt_c, t_cum, rid, cmp.valid, CHUNK, True)
    k3 = composite_rays_compact(*k3args)
    p3 = composite_rays_compact_plain(*k3args)
    err3 = max(max_abs(a, b) for a, b in zip(k3, p3))
    M = budget
    log(f"K3 stream: budget {M}, valid samples {int(cmp.total)}, "
        f"weights_sum max {float(k3[0].max()):.4f}")
    b3 = bound(M * (4 + 12 + 4 + 4 + 8 + 1) + M * 4 + CHUNK * 20, M * 16)
    results.append(dict(
        name="composite_rays_compact",
        source="pvd_tpu_torch/csrc/composite.cu",
        replaces="pvd_tpu/ops/composite.py:28", err=err3, tol=TOL_K3,
        **timings(lambda: composite_rays_compact(*k3args),
                  lambda: composite_rays_compact_plain(*k3args)),
        bound=b3, shape=f"M={M} slots, N={CHUNK} rays"))

    # K4, K5, K6 on one stage-3 batch of the distill path
    xn, compact, comp = path_inputs(cfg, spec_stu, state, pose_t, intr, gen)
    log(f"distill batch: {int(compact.total)} valid samples, budget "
        f"{xn.shape[0]}")
    results += check_vm_kernels(state, xn, compact, gen)
    results.append(check_composite_bwd(comp, gen))

    # ---- end to end: the kernel path on the GPU against the plain path on
    # the CPU (the path the tests hold against the JAX package), f32 heads
    spec32 = dataclasses.replace(spec, compute_dtype="float32")
    occ_cpu = occ.replace(**{f: getattr(occ, f).cpu() for f in (
        "density_grid", "bitfield", "mean_density", "aabb_train",
        "aabb_infer")})
    small = {}
    for where, f_dev, o_dev in (
            ("cuda", hash_field_from_jax(tree, spec32, dev), occ),
            ("cpu", hash_field_from_jax(tree, spec32, "cpu"), occ_cpu)):
        small[where] = make_eval_renderer(spec32, rspec, chunk=E2E_CHUNK,
                                          device=where)(
            f_dev, o_dev, poses[0], intr_e2e, E2E_RES, E2E_RES)
    e2e_err = max(max_abs(small["cuda"].image.cpu(), small["cpu"].image),
                  max_abs(small["cuda"].depth.cpu(), small["cpu"].depth))
    e2e_hit = float((small["cpu"].weights_sum > 0.01).float().mean())
    log(f"end to end {E2E_RES}x{E2E_RES} (f32 heads): max |GPU kernels - "
        f"CPU plain| {e2e_err:.3g} (tol {TOL_E2E:g}); rungs "
        f"{small['cuda'].rungs}/{small['cpu'].rungs}; rays with "
        f"weights_sum>0.01 {e2e_hit:.3f}")
    if not (e2e_err <= TOL_E2E and 0.0 < e2e_hit < 1.0):
        raise RuntimeError("the GPU render disagrees with the CPU plain "
                           "path")
    step_check = small_step_gpu_vs_cpu()
    descent = fixed_batch_descent(cfg, spec_stu, spec, opt, state, field,
                                  pose_t, intr, gen)

    # ---- main path 3: teacher training (the recipe) + its test renders --
    reset_counters()
    trainer, scene, teacher = drive_teacher(args.seed)
    teacher_launches = counters()
    log(f"launches on the teacher path ({RECIPE['iters']} steps, "
        f"{RECIPE['n_test']} renders): {json.dumps(teacher_launches)}")
    for name in TEACHER_KERNELS:
        if teacher_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the "
                               "teacher path")
    t_results, t_extra = check_teacher_kernels(trainer, scene, gen)
    results += t_results
    flavors = teacher_step_flavors(trainer, scene)
    teacher_check = small_teacher_gpu_vs_cpu()

    bad = [r["name"] for r in results if not r["err"] <= r["tol"]]
    for r in results:
        lib = r.get("library_ms")
        log(f"{r['name']} ({r['shape']}): "
            f"{r.get('err_kind', 'max |kernel - plain|')} {r['err']:.3g}"
            f" (tol {r['tol']:g}), kernel {r['ms']:.4f} ms (call "
            f"{r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})"
            + ("" if lib is None else f", library {lib:.4f} ms "
               f"({r['library_call']})"))
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    def launch_fields(name):
        if name in SERVE_KERNELS:
            f = {"launches": launches[name],
                 "launches_per_image": launches[name] / len(poses)}
        elif distill_launches[name]:
            f = {"launches": distill_launches[name]}
        else:
            f = {"launches": teacher_launches[name]}
        f["launches_distill"] = distill_launches[name]
        f["launches_per_distill_step"] = distill_launches[name] / n_steps
        f["launches_teacher"] = teacher_launches[name]
        f["launches_per_teacher_step"] = {
            flv: v["launches_per_step"].get(name, 0)
            for flv, v in flavors.items()}
        return f

    def brief(prof):
        return {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                     "device_busy_share", "ours")}

    line = {"kernels": [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], **launch_fields(r["name"]),
        "max_abs_err": r.get("abs_err", r["err"]),
        "max_abs_diff": r.get("abs_err", r["err"]), "tol_err": r["err"],
        "tol": r["tol"],
        "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r.get("library_ms"),
        "library_call": r.get("library_call"), "shape": r["shape"]}
        for r in results],
        "sweep_ms": sweep_ms, "images": images, "build_s": build_s,
        "e2e_max_abs_diff": e2e_err, "profile": brief(prof),
        "distill": {"stages": stages, "profile_stage3": brief(prof_d),
                    "gpu_vs_cpu_step": step_check,
                    "fixed_batch_losses": descent},
        "teacher": {**teacher, "kernel_extra": t_extra,
                    "profiles": {k: brief(v["profile"])
                                 for k, v in flavors.items()},
                    "gpu_vs_cpu_step": teacher_check},
        "card": card}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
