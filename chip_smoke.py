#!/usr/bin/env python3
"""Smoke test of pvd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from pvd_tpu_torch/csrc (nvcc, sm_90a).
2. Drives the serving path at the full INGP width (14 levels x 2, 2^19
   table, bf16 heads, grid 128^3, 1024-step march, 16 samples/ray budget)
   with seeded random weights: one full occupancy sweep (2,097,152 density
   queries), then three 800x800 renders with make_eval_renderer on a
   ~4%-occupancy object grid.  Every kernel's launch counter is zeroed just
   before and read just after; each must have launched.
3. Holds each kernel against its plain PyTorch version on inputs taken from
   that path, and times both (CUDA events, median after warm-up).
4. Prints the GPU's name and power limit, a {"kernels": [...]} line, and
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
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.engine.train_steps import (chunk_rays, make_eval_renderer,
                                              make_occ_update)
from pvd_tpu_torch.models.hash_field import grid_spec
from pvd_tpu_torch.ops.aabb import near_far_from_aabb
from pvd_tpu_torch.ops.composite import (composite_rays_compact,
                                         composite_rays_compact_plain)
from pvd_tpu_torch.ops.hashgrid import hash_encode, hash_encode_plain
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import hash_field_from_jax
from pvd_tpu_torch.render.occupancy import (grid_coords, init_occupancy_state,
                                            query_points, set_bitfield)
from pvd_tpu_torch.render.renderer import (compact_samples, dt_min_of,
                                           march_rays, march_rays_plain)

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores; the bounds below are the larger of bytes/BW and ops/F32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

RES, CHUNK = 800, 4096
OUR_KERNELS = ("hash_encode_fwd_kernel", "march_rays_kernel",
               "segment_bounds_kernel", "composite_kernel")
TOL_K1, TOL_K2_DD, TOL_K3 = 1e-5, 1e-6, 1e-5
# end-to-end image and depth, kernel path on the GPU vs plain path on the
# CPU: the same samples (K2 is exact), f32 heads summed in other orders
E2E_RES, E2E_CHUNK, TOL_E2E = 64, 1024, 1e-4


def object_like_bitfield(H: int) -> np.ndarray:
    """Deterministic ~4% occupancy clustered like a trained object grid:
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


def pose_spherical(theta_deg: float, phi_deg: float, radius: float):
    """Blender-style spherical c2w (the NeRF synthetic test orbit)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi = phi_deg / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(phi), -np.sin(phi), 0],
                        [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]],
                       np.float32)
    th = theta_deg / 180.0 * np.pi
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]],
                         np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ rot_theta @ rot_phi @ c2w


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


def counters() -> dict:
    return {"hash_encode": hash_encode.launches,
            "march_rays": march_rays.launches,
            "composite_rays_compact": composite_rays_compact.launches}


def reset_counters():
    hash_encode.launches = 0
    march_rays.launches = 0
    composite_rays_compact.launches = 0


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
        for name in OUR_KERNELS:
            if key.startswith(name + "("):
                ours[name] = {"ms": ms, "calls": n}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "ours": ours,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for ms, n, k in rows[:top]]}


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
    # random weights make no object: march the ~4% object grid instead
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
    launches = counters()
    log(f"launches on the main path: {json.dumps(launches)}")
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

    bad = [r["name"] for r in results if not r["err"] <= r["tol"]]
    for r in results:
        log(f"{r['name']} ({r['shape']}): max |kernel - plain| {r['err']:.3g}"
            f" (tol {r['tol']:g}), kernel {r['ms']:.4f} ms (call "
            f"{r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    line = {"kernels": [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": launches[r["name"]],
        "launches_per_image": launches[r["name"]] / len(poses),
        "max_abs_err": r["err"], "max_abs_diff": r["err"], "tol": r["tol"],
        "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None, "shape": r["shape"]} for r in results],
        "sweep_ms": sweep_ms, "images": images, "build_s": build_s,
        "e2e_max_abs_diff": e2e_err,
        "profile": prof, "card": card}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
