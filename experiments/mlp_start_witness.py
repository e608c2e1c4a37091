#!/usr/bin/env python3
"""How the MLP teacher leaves its flat start, in the JAX package and in the
port.

    env JAX_PLATFORMS=cpu python3 experiments/mlp_start_witness.py \
        --package {jax,torch} --seeds 0 [--steps 600] [--num_rays 1024] \
        [--threads 2]
    python3 experiments/mlp_start_witness.py --package torch --device cuda \
        --seeds 0,1,2,3,4,5 --num_rays 4096 --precision bf16,fp32 \
        [--host] [--trunk_dtype {bfloat16,float32}]

Trains the MLP teacher (PE 10, 8 x 256, skip 3: the full width) on the
synthetic scene of `chip_smoke.py`'s A/B recipe (100 views at 96 x 96)
with that recipe's settings (grid 64, preloaded images, or the host
batcher with --host, port only) through one package's Trainer, once per
seed and precision (`--trunk_dtype` sets the 8 x 256 layers' dtype apart
from the heads'), and prints one JSON line a run: the batch PSNR and
mask_frac at every 100th step (the JAX Trainer's log cadence); the port's
runs add the mean batch PSNR of each 100 steps and the share of grid
cells occupied after the last occupancy update before each 100th step;
before and after training, the field's least and largest density on a
40^3 lattice of [-1, 1]^3 and the share of its points whose sigma logit
lies under sigma_clip_min (-2), where the forward's clip passes no
gradient; the port's runs add the share of sigma_net's hidden units that
fire at some point of it.
A start that stalls sits at ~17-18 dB with most of the grid occupied.
The two packages draw from different generators (JAX keys against
torch.Generator), so a seed names one start in each, not the same start:
compare how often each stalls over several seeds.  On the CPU run one
process per (package, seed), each pinned to its own cores (`taskset`):
600 steps at 1024 rays take ~11 min (the port) and ~35 min (the JAX
package) at 2 threads.  The JAX package
runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCENE = dict(n_train=100, n_val=1, n_test=1, H=96, W=96)


def settings(args, seed: int, precision: str) -> dict:
    return dict(model_type="mlp", iters=3000, grid_size=64,
                num_rays=args.num_rays, eval_interval=10 ** 6,
                preload=not args.host, seed=seed, precision=precision)


def run_jax(args, ws: str, seed: int, precision: str) -> dict:
    from pvd_tpu.config import PVDConfig
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene
    from pvd_tpu.engine.trainer import Trainer

    root = make_synthetic_scene(os.path.join(ws, "scene"), **SCENE,
                                seed=seed)
    cfg = PVDConfig(path=root, workspace=os.path.join(ws, "run"),
                    **settings(args, seed, precision))
    tr = Trainer(cfg, mode="teacher")
    probe = jax_probe(tr)
    sigma0, clipped0 = probe()
    tr.train(NeRFDataset(cfg, "train"), max_steps=args.steps)
    sigma1, clipped1 = probe()
    with open(os.path.join(cfg.workspace, "log_mlp.txt")) as f:
        text = f.read()
    rows = [(int(m.group(1)), float(re.search(r"psnr=([\d.]+)", m.group(0))
                                    .group(1)),
             float(re.search(r"mask_frac=([\d.]+)", m.group(0)).group(1)))
            for m in re.finditer(r"\[mlp\] step (\d+)/\d+ .*", text)]
    return {"start": rows, "sigma_range": [sigma0, sigma1],
            "logit_clipped": [clipped0, clipped1]}


def lattice_points(n: int = 40):
    import numpy as np

    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def jax_probe(tr):
    """probe() -> ([least, largest] density on the lattice, the share of
    lattice points whose sigma logit in the training forward's dtype lies
    under sigma_clip_min, where the clip passes no gradient)."""
    import jax
    import jax.numpy as jnp

    from pvd_tpu.models import mlp_field
    from pvd_tpu.models.api import field_density
    from pvd_tpu.models.common import apply_mlp

    spec, pts = tr.spec_stu, jnp.asarray(lattice_points())
    aabb = jnp.asarray([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], jnp.float32)

    @jax.jit
    def stats(params):
        sigma = field_density(params, spec, pts, aabb)
        enc = mlp_field._encode(params, spec, pts)
        logit = apply_mlp(params["sigma_net"], enc.astype(
            jnp.dtype(spec.compute_dtype)))[:, 0].astype(jnp.float32)
        return sigma.min(), sigma.max(), jnp.mean(
            logit < spec.sigma_clip_min)

    def probe():
        lo, hi, clipped = stats(tr.state.params)
        return [float(lo), float(hi)], float(clipped)

    return probe


def run_torch(args, ws: str, seed: int, precision: str) -> dict:
    import torch

    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.data.synth import make_synthetic_scene
    from pvd_tpu_torch.engine.trainer import Trainer

    if args.device == "cpu":
        torch.set_num_threads(args.threads)
    if args.trunk_dtype:
        # the nerf MLP's layers in this dtype, the heads in --precision's
        from pvd_tpu_torch.models import mlp_field
        mlp_field.compute_dtype = lambda spec: getattr(torch,
                                                       args.trunk_dtype)
    scene = make_synthetic_scene(**SCENE, seed=seed,
                                 scale=PVDConfig().scale)
    tr = Trainer(PVDConfig(workspace=os.path.join(ws, "run"),
                           **settings(args, seed, precision)),
                 device=args.device)
    from pvd_tpu_torch.models.heads import compute_dtype

    from pvd_tpu_torch.models.common import apply_mlp

    pts = torch.from_numpy(lattice_points()).to(tr.device)

    @torch.no_grad()
    def probe():
        """jax_probe's numbers, and the share of sigma_net's hidden units
        that fire (> 0) at some lattice point."""
        field = tr.state.field
        sigma = field.density(pts)
        cdt = compute_dtype(field.spec)
        enc = field.encode(pts).to(cdt)
        logit = apply_mlp(field.sigma_net, enc)[:, 0].float()
        pre = torch.nn.functional.linear(enc, field.sigma_net[0].weight.to(
            cdt))
        return ([float(sigma.min()), float(sigma.max())],
                float((logit < field.spec.sigma_clip_min).float().mean()),
                float((pre > 0).any(0).float().mean()))

    sigma0, clipped0, live0 = probe()
    occupied = []  # (step of the update, share of cells occupied)
    update = tr._update_occ

    def logged_update():
        full = update()
        occupied.append((len(tr.history),
                         float(tr.state.occ.bitfield.float().mean())))
        return full

    tr._update_occ = logged_update
    tr.train(scene["train"], max_steps=args.steps)
    sigma1, clipped1, live1 = probe()
    psnr = [float(m["psnr"]) for m in tr.history]
    rows = [(i, psnr[i], float(tr.history[i]["mask_frac"]))
            for i in range(0, args.steps, 100)]
    means = [sum(psnr[i:i + 100]) / len(psnr[i:i + 100])
             for i in range(0, args.steps, 100)]
    occ = [max((o for o in occupied if o[0] <= i), default=(0, None))[1]
           for i in range(0, args.steps, 100)]
    return {"start": rows, "mean_psnr_100": means, "occupied": occ,
            "sigma_range": [sigma0, sigma1],
            "logit_clipped": [clipped0, clipped1],
            "sigma_net_live": [live0, live1],
            "host_batcher": tr.train_stats["host_batcher"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds, one run each")
    ap.add_argument("--precision", default="bf16",
                    help="comma-separated: bf16, fp32")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the JAX package: cpu only)")
    ap.add_argument("--host", action="store_true",
                    help="the port's host batcher instead of preloaded "
                         "images")
    ap.add_argument("--trunk_dtype", choices=("bfloat16", "float32"),
                    default=None,
                    help="the port's nerf MLP layers in this dtype, the "
                         "heads in --precision's")
    args = ap.parse_args(argv)
    if args.package == "jax" and (args.device != "cpu" or args.host
                                  or args.trunk_dtype):
        ap.error("the JAX package runs here on the CPU, preloaded")
    run = run_jax if args.package == "jax" else run_torch
    for precision in args.precision.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="mlp_start_") as ws:
                out = run(args, ws, seed, precision)
            out.update(package=args.package, seed=seed, precision=precision,
                       steps=args.steps, num_rays=args.num_rays,
                       device=args.device, host=args.host,
                       trunk_dtype=args.trunk_dtype,
                       wall_s=time.perf_counter() - t0)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
