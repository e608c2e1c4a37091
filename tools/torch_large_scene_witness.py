#!/usr/bin/env python3
"""Does the JAX package's Trainer fail the large-scene teacher on a white
background the way pvd_tpu_torch's does?  Trains the same small
large-scene teacher with both packages' Trainers on the CPU, on the
synthetic scene composited on white, with and without the background
model (and the port's once more on the scene over a sky dome, which only
the port can make), and prints one JSON line per run: test PSNR and SSIM,
the occupied share of each occupancy cascade, and the sample budget the
autotuner ended at.

    env JAX_PLATFORMS=cpu python3 tools/torch_large_scene_witness.py \\
        [--iters 1500] [--threads 2]

The configuration is chip_smoke.py's large-scene teacher (bound 2, so two
cascades; dt_gamma 1/256; bg_radius 32; 1024 march steps; max_samples 64;
the INGP field with 9 cell levels) cut to run on a CPU: grid 32 (not 128),
1024 rays per step (not 4096), 32/1/4 views at 48x48 (not 100/3/10 at
96x96), 1500 steps (not 3000).  The runs start together, one process each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(bound=2.0, dt_gamma=1.0 / 256.0, bg_radius=32.0, grid_size=32,
           max_steps=1024, max_samples=64, num_rays=1024, hash_cell_levels=9,
           eval_interval=100000, seed=0)
SCENE = dict(n_train=32, n_val=1, n_test=4, H=48, W=48)
# (package, variant): white = the scene on white with the background model
RUNS = (("jax", "white"), ("torch", "white"), ("jax", "no_bg"),
        ("torch", "no_bg"), ("torch", "sky"))


def run_torch(variant: str, iters: int, threads: int) -> dict:
    import torch

    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.data.synth import make_synthetic_scene
    from pvd_tpu_torch.engine.trainer import Trainer

    torch.set_num_threads(threads)
    cfg = dict(CFG, iters=iters,
               **({"bg_radius": -1.0} if variant == "no_bg" else {}))
    sky = CFG["bg_radius"] / PVDConfig().scale if variant == "sky" else 0.0
    scene = make_synthetic_scene(**SCENE, sky_radius=sky)
    with tempfile.TemporaryDirectory() as ws:
        tr = Trainer(PVDConfig(**cfg, workspace=ws), device="cpu")
        tr.train(scene["train"])
        st = tr.evaluate(scene["test"])
        occ = tr.state.occ.bitfield.reshape(tr.rspec.cascades, -1)
        occupied = [float(b.float().mean()) for b in occ]
    return dict(psnr=st["psnr"], ssim=st["ssim"], occupied=occupied,
                max_samples=tr.rspec.max_samples,
                samples_per_ray=tr.rspec.samples_per_ray)


def run_jax(variant: str, iters: int, threads: int) -> dict:
    os.environ["XLA_FLAGS"] = (
        "--xla_cpu_multi_thread_eigen=false "
        f"intra_op_parallelism_threads={threads}")
    import numpy as np

    from pvd_tpu.config import PVDConfig
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene
    from pvd_tpu.engine.trainer import Trainer

    cfg = dict(CFG, iters=iters,
               **({"bg_radius": -1.0} if variant == "no_bg" else {}))
    with tempfile.TemporaryDirectory() as tmp:
        root = make_synthetic_scene(os.path.join(tmp, "scene"), **SCENE)
        jcfg = PVDConfig(path=root, tensorboard=False,
                         workspace=os.path.join(tmp, "ws"), **cfg)
        tr = Trainer(jcfg, mode="teacher")
        tr.train(NeRFDataset(jcfg, "train"))
        st = tr.evaluate(NeRFDataset(jcfg, "test"))
        occ = np.asarray(tr.state.occ.bitfield).reshape(tr.rspec.cascades, -1)
    return dict(psnr=float(st["psnr"]), ssim=float(st["ssim"]),
                occupied=[float(b.mean()) for b in occ],
                max_samples=tr.rspec.max_samples,
                samples_per_ray=tr.rspec.samples_per_ray)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--threads", type=int, default=2,
                    help="CPU threads per run")
    ap.add_argument("--run", nargs=2, metavar=("PACKAGE", "VARIANT"),
                    help="one run in this process")
    args = ap.parse_args(argv)
    if args.run:
        package, variant = args.run
        sys.path.insert(0, ROOT)
        t0 = time.perf_counter()
        fn = run_jax if package == "jax" else run_torch
        res = fn(variant, args.iters, args.threads)
        print("RESULT " + json.dumps(dict(
            package=package, variant=variant, iters=args.iters, **res,
            wall_s=time.perf_counter() - t0)), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--iters",
         str(args.iters), "--threads", str(args.threads), "--run", p, v],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
        for p, v in RUNS]
    ok = True
    for (p, v), proc in zip(RUNS, procs):
        out, _ = proc.communicate()
        lines = [ln[7:] for ln in out.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            ok = False
            print(json.dumps({"package": p, "variant": v,
                              "error": proc.returncode}), flush=True)
        else:
            print(lines[-1], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
