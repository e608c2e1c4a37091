#!/usr/bin/env python3
"""Does the host-batched teacher train worse than the preloaded one, in the
JAX package as in the port?

    env JAX_PLATFORMS=cpu python3 experiments/host_batcher_witness.py \
        --package {jax,torch} --path {host,preload} --seeds 0,1,2,3 \
        [--steps 600] [--num_rays 1024] [--threads 1]
    python3 experiments/host_batcher_witness.py --package torch \
        --device cuda --path host,preload --seeds 0,1,2,3,4,5 --full

Trains the cell-mode hash teacher (the full INGP width, 9 cell levels: the
A/B recipe's teacher) through one package's Trainer, once per path and
seed, and prints one JSON line a run: the test PSNR and SSIM of the
trained field under that package's `evaluate`, and the mean batch PSNR of
the last 100 steps.  "host" takes every batch from the package's native
batcher (`RayBatcher`) with one producer thread, so a seed gives the same
image and pixel ids, batch for batch, in both packages; "preload" draws
them on the device from the preloaded images.  The scene is the same in
every run (seed 0); the seed is the Trainer's.

The CPU size: the synthetic scene with 20 training and 4 test views at
48 x 48, grid 32, 256 march steps, 1024 rays, 600 steps (the first 256
padded); ~6.5 min a run for the port and ~26 for the JAX package at
one thread.  `--full` runs `chip_smoke.py`'s A/B teacher settings instead
(grid 64, 4096 rays, 3000 steps; 100 training and 10 test views at 96 x
96, no val split, so other test views than chip_smoke.py's): the port on
the GPU, 33-52 s a run on an H100.  The JAX package runs on the CPU
only.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SMALL_SCENE = dict(n_train=20, n_val=0, n_test=4, H=48, W=48)
FULL_SCENE = dict(n_train=100, n_val=0, n_test=10, H=96, W=96)


def settings(args, seed: int, path: str) -> dict:
    cfg = dict(model_type="hash", hash_cell_levels=9, eval_interval=10 ** 6,
               preload=path == "preload", seed=seed)
    if args.full:
        return dict(cfg, iters=3000, grid_size=64, num_rays=4096)
    return dict(cfg, iters=args.steps, grid_size=32, max_steps=256,
                num_rays=args.num_rays)


def run_jax(args, ws: str, seed: int, path: str) -> dict:
    import numpy as np

    from pvd_tpu.config import PVDConfig
    from pvd_tpu.data import raybatch
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene
    from pvd_tpu.engine.trainer import Trainer

    os.environ["PVD_DISABLE_TB"] = "1"
    raybatch.RayBatcher = functools.partial(raybatch.RayBatcher,
                                            n_threads=1)
    scene = FULL_SCENE if args.full else SMALL_SCENE
    root = make_synthetic_scene(os.path.join(ws, "scene"), **scene, seed=0)
    cfg = PVDConfig(path=root, workspace=os.path.join(ws, "run"),
                    **settings(args, seed, path))
    tr = Trainer(cfg, mode="teacher")
    psnr = []
    step = tr._steps  # the step functions are wrapped to log batch PSNR

    class Recording(dict):
        def __getitem__(self, key):
            fn = dict.__getitem__(self, key)

            def logged(*a):
                out = fn(*a)
                psnr.append(out[-1]["psnr"])
                return out
            return logged

    tr._steps = Recording(step)
    tr.train(NeRFDataset(cfg, "train"))
    st = tr.evaluate(NeRFDataset(cfg, "test"))
    tail = [float(p) for p in psnr[-100:]]
    return {"psnr": st["psnr"], "ssim": st["ssim"],
            "batch_psnr_last100": float(np.mean(tail)),
            "steps_logged": len(psnr)}


def run_torch(args, ws: str, seed: int, path: str) -> dict:
    import numpy as np
    import torch

    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.data.synth import make_synthetic_scene
    from pvd_tpu_torch.engine import trainer as trainer_mod

    if args.device == "cpu":
        torch.set_num_threads(args.threads)
    trainer_mod.RayBatcher = functools.partial(trainer_mod.RayBatcher,
                                               n_threads=1)
    scene = make_synthetic_scene(**(FULL_SCENE if args.full
                                    else SMALL_SCENE), seed=0,
                                 scale=PVDConfig().scale)
    tr = trainer_mod.Trainer(PVDConfig(workspace=os.path.join(ws, "run"),
                                       **settings(args, seed, path)),
                             device=args.device)
    tr.train(scene["train"])
    st = tr.evaluate(scene["test"])
    tail = [float(m["psnr"]) for m in tr.history[-100:]]
    return {"psnr": st["psnr"], "ssim": st["ssim"],
            "batch_psnr_last100": float(np.mean(tail)),
            "host_batcher": tr.train_stats["host_batcher"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--path", default="host,preload",
                    help="comma-separated: host, preload")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated Trainer seeds, one run each")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the JAX package: cpu only)")
    ap.add_argument("--full", action="store_true",
                    help="chip_smoke.py's A/B teacher at its full size")
    args = ap.parse_args(argv)
    if args.package == "jax" and args.device != "cpu":
        ap.error("the JAX package runs here on the CPU")
    run = run_jax if args.package == "jax" else run_torch
    for path in args.path.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="host_witness_") as ws:
                out = run(args, ws, seed, path)
            out.update(package=args.package, path=path, seed=seed,
                       full=args.full, device=args.device,
                       wall_s=time.perf_counter() - t0)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
