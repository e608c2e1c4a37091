"""Shared argparse plumbing of the CLIs (port of pvd_tpu/cli/common.py).

`base_parser` has the JAX package's flags, defaults and help, which keep
the reference's flag names (main_just_train_tea.py:15-215,
main_distill_mutual.py:43-236); values land in one PVDConfig.  Flags the
reference's GPU build needed (--ff, --tcnn, the --gui group) are accepted
and ignored, as in the JAX package.  --num_steps and --upsample_steps
set the stratified renderer's counts (`render_stratified`), which no
Trainer path reads, as in the JAX package.  The Trainer raises for the
option combinations it does not run, naming their ROADMAP item.  The
help of --n_devices and --scan_steps is the JAX package's word for word;
in the port --n_devices N means N processes under `torchrun
--nproc_per_node N` and --scan_steps K runs K steps a call
(`engine/trainer.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from pvd_tpu_torch.config import PVDConfig


def base_parser(distill: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("-O", action="store_true",
                   help="accepted for compatibility (bf16+grid-march is "
                        "always on; there is no AMP GradScaler on TPU)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=40000 if not distill else 30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=8192 if not distill else 4096)
    p.add_argument("--cuda_ray", action="store_true",
                   help="compat alias: occupancy-grid marching (always used)")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=512)
    p.add_argument("--upsample_steps", type=int, default=0)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--fp16", action="store_true",
                   help="compat alias for --precision bf16")
    p.add_argument("--ff", action="store_true", help="ignored (GPU-only)")
    p.add_argument("--tcnn", action="store_true", help="ignored (GPU-only)")
    p.add_argument("--mode", type=str, default="blender")
    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--bound", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=0.8)
    p.add_argument("--dt_gamma", type=float, default=0.0)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10.0)
    p.add_argument("--bg_radius", type=float, default=-1.0)
    p.add_argument("--error_map", action="store_true")
    p.add_argument("--distill_mode", type=str, default="no_fix_mlp",
                   choices=["fix_mlp", "no_fix_mlp"])
    p.add_argument("--loss_rate_rgb", type=float, default=1.0)
    p.add_argument("--loss_rate_fea_sc", type=float,
                   default=0.1 if not distill else 0.002)
    p.add_argument("--loss_rate_color", type=float,
                   default=0.0 if not distill else 0.002)
    p.add_argument("--loss_rate_sigma", type=float,
                   default=0.0 if not distill else 0.002)
    p.add_argument("--l1_reg_weight", type=float, default=1e-4)
    p.add_argument("--ckpt_teacher", type=str, default="")
    p.add_argument("--ckpt_student", type=str, default="")
    p.add_argument("--sigma_clip_min", type=float, default=-2.0)
    p.add_argument("--sigma_clip_max", type=float, default=7.0)
    p.add_argument("--test_teacher", action="store_true")
    p.add_argument("--resolution0", type=int, default=300)
    p.add_argument("--resolution1", type=int, default=300)
    p.add_argument("--upsample_model_steps", type=int, action="append",
                   default=[])
    p.add_argument("--loss_type", type=str, default="L2",
                   choices=["normL2", "L2", "normL1", "smoothL1"])
    p.add_argument("--PE", type=int, default=10)
    p.add_argument("--nerf_layer_num", type=int, default=8)
    p.add_argument("--nerf_layer_wide", type=int, default=256)
    p.add_argument("--skip", type=int, default=3)
    p.add_argument("--model_type", default="hash", type=str)
    p.add_argument("--teacher_type", default="hash", type=str)
    p.add_argument("--update_stu_extra", action="store_true")
    p.add_argument("--ema_decay", type=float, default=-1.0)
    p.add_argument("--grid_size", type=int, default=128)
    p.add_argument("--plenoxel_degree", type=int, default=3)
    p.add_argument("--plenoxel_res", type=str, default="[128,128,128]")
    p.add_argument("--data_type", type=str, default="synthetic")
    p.add_argument("--downscale", type=int, default=1)
    # accepted-and-ignored flags for drop-in compatibility with reference
    # launch scripts (GUI is CUDA-app-only; the rest are dead/vestigial in
    # the reference too: main_just_train_tea.py:129-183)
    for flag in ("--gui",):
        p.add_argument(flag, action="store_true", help="ignored (GPU GUI)")
    p.add_argument("--W", type=int, default=1920, help="ignored (GUI)")
    p.add_argument("--H", type=int, default=1080, help="ignored (GUI)")
    p.add_argument("--radius", type=float, default=5, help="ignored (GUI)")
    p.add_argument("--fovy", type=float, default=50, help="ignored (GUI)")
    p.add_argument("--max_spp", type=int, default=64, help="ignored (GUI)")
    p.add_argument("--clip_text", type=str, default="", help="ignored")
    p.add_argument("--rand_pose", type=int, default=-1,
                   help="orbit-pose injection into distill epochs (0 = only "
                        "orbit poses; >0 = one per N scheduled; teacher mode "
                        "warns — needs the reference's disabled CLIP loss)")
    p.add_argument("--loss_rate_fea", type=float, default=0.1,
                   help="ignored (superseded by --loss_rate_fea_sc, as in "
                        "the reference)")
    p.add_argument("--L1_tensorAB_reg", type=float, default=1e-3,
                   help="ignored (vestigial in the reference)")
    p.add_argument("--use_sigma_clip", action="store_true", help="ignored")
    p.add_argument("--nerf_pe", action="store_true", help="ignored")
    p.add_argument("--use_real_gt", action="store_true", help="ignored")
    p.add_argument("--use_diagonal_matrix", action="store_true",
                   help="ignored")
    p.add_argument("--loss_rate_real_gt", type=float, default=0,
                   help="ignored")
    p.add_argument("--test_metric", action="store_true", help="ignored")
    p.add_argument("--residual", type=int, default=3, help="ignored")
    p.add_argument("--use_upsample_vm", action="store_true",
                   help="accepted (upsampling is driven by "
                        "--upsample_model_steps)")
    p.add_argument("--just_train_a_model", action="store_true",
                   help="accepted (implicit in the teacher CLI)")
    p.add_argument("--enable_edit_plenoxel", action="store_true",
                   help="apply the plenoxel region-erase demo to tensors "
                        "teachers (network.py:313-316)")
    # TPU-specific knobs
    p.add_argument("--max_samples", type=int, default=96,
                   help="padded per-ray sample budget (replaces mean_count)")
    p.add_argument("--hash_cell_levels", type=int, default=0,
                   help="finest hashed levels in cell-packed fast mode "
                        "(1 gather/pt/level; 0 = reference parity)")
    p.add_argument("--hash_bake_dense", action="store_true",
                   help="bake the FROZEN hash teacher's dense levels onto "
                        "the finest dense lattice (1 gathered row for all "
                        "of them; coarser levels resampled — A/B'd)")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel devices over the ray axis "
                        "(0 = all local devices)")
    p.add_argument("--samples_per_ray", type=float, default=16.0,
                   help="global sample budget per ray (mean_count analog; "
                        "0 disables compaction)")
    p.add_argument("--no_autotune_budget", dest="autotune_budget",
                   action="store_false",
                   help="freeze S_max / sample budget (no bucket adaptation)")
    p.add_argument("--scan_steps", type=int, default=0,
                   help="fuse K train steps (teacher or distill) into one "
                        "lax.scan dispatch (TPU host-overhead amortization; "
                        "0 = off)")
    p.add_argument("--wall_budget", type=float, default=0.0,
                   help="graceful wall-clock budget for training in seconds "
                        "(0 = unlimited); ends early at an epoch boundary "
                        "with the normal final checkpoint + eval")
    return p


def upsample_schedule(cfg: PVDConfig) -> list:
    """The resolutions of the scheduled resizes: one per entry of
    `upsample_model_steps`, log-spaced from resolution0 to resolution1
    with resolution0 left out (common.py:156-170).  The Trainer turns each
    into a per-axis resolution over the current aabb when it resizes."""
    n = len(cfg.upsample_model_steps)
    if n == 0:
        return []
    return np.round(np.exp(np.linspace(
        np.log(cfg.resolution0), np.log(cfg.resolution1), n + 1))
    ).astype(int).tolist()[1:]


def to_config(args) -> PVDConfig:
    """The PVDConfig of parsed flags; flags that are no config field (the
    ignored ones, --test, ...) are left out."""
    raw = dict(vars(args))
    if isinstance(raw.get("plenoxel_res"), str):
        raw["plenoxel_res"] = tuple(json.loads(raw["plenoxel_res"]))
    raw["upsample_model_steps"] = tuple(raw.get("upsample_model_steps")
                                        or ())
    return PVDConfig.from_dict(raw)


def write_args_txt(cfg: PVDConfig, workspace: str):
    """The full config as `<workspace>/args.json` (PVDConfig.from_json
    reads it back: --load_args)."""
    os.makedirs(workspace, exist_ok=True)
    with open(os.path.join(workspace, "args.json"), "w") as f:
        f.write(cfg.to_json())


def save_codes_env(workspace: str):
    """Copy the package's source into `<workspace>/codes_env/pvd_tpu_torch`
    (the reference's save_codes_env, main_distill_mutual.py:15-21); built
    kernels and caches are left out."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(workspace, "codes_env", "pvd_tpu_torch")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc", "build"))


def finalize_run(trainer, cfg: PVDConfig):
    """Write the final metrics to `<workspace>/metrics.json` and rename
    the workspace with its PSNR suffix, `<workspace>-psnrXX.XX`
    (main_just_train_tea.py:347-354); returns the workspace's path.  In a
    data-parallel run only rank 0 writes and renames."""
    if trainer.rank != 0:
        return cfg.workspace
    stats = trainer.stats
    with open(os.path.join(cfg.workspace, "metrics.json"), "w") as f:
        json.dump(stats, f, indent=2)
    if stats.get("psnr"):
        dst = f"{cfg.workspace}-psnr{stats['psnr']:.2f}"
        try:
            os.rename(cfg.workspace, dst)
            print(f"[workspace] -> {dst}", flush=True)
            return dst
        except OSError:
            pass
    return cfg.workspace
