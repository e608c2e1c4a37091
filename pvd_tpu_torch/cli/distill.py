"""Distillation CLI (port of pvd_tpu/cli/distill.py; the reference's
main_distill_mutual.py).

Usage:
  python -m pvd_tpu_torch.cli.distill <data_path> --teacher_type hash \
      --model_type vm --ckpt_teacher ws_hash/checkpoints/hash_best.ckpt \
      --workspace ws_h2v [--hash_cell_levels 9 --hash_bake_dense] \
      [--stage_iters stage1=2000,stage2=5000 ...]
  python -m pvd_tpu_torch.cli.distill <data_path> --test --workspace ws_h2v
  python -m pvd_tpu_torch.cli.distill <data_path> --test_teacher ...

Any teacher and student of hash, mlp, vm and tensors.  Training reads the
blender-format scene at <data_path> (train, val when the scene has it,
test), loads and freezes the teacher checkpoint (a hash teacher baked with
--hash_bake_dense; a tensors teacher edited with --enable_edit_plenoxel),
resumes the student from the workspace's latest
checkpoint under `--ckpt latest` (any other value starts from scratch),
distills, evaluates the test split into `<workspace>/results` and writes
`metrics.json`, then renames the workspace with its PSNR suffix.
`--test` / `--test_teacher` / `--test_type_trainval` render the student
(or the teacher) again.  `--upsample_model_steps`, `--error_map` and
`--ema_decay` act as in the teacher CLI (the error map per pose slot,
updated at stage 3).  `--scan_steps K` runs K steps a call where no host
work falls inside them; `torchrun --nproc_per_node N -m
pvd_tpu_torch.cli.distill ... --n_devices N` distills data parallel on N
cards (rank 0 writes).  Runs on the GPU; `main(argv, device="cpu")` runs
the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import sys

from pvd_tpu_torch.cli.common import (base_parser, finalize_run,
                                      save_codes_env, to_config,
                                      upsample_schedule, write_args_txt)
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.provider import NeRFDataset
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.utils.misc import seed_everything


def parse_stage_iters(text: str) -> dict:
    """'stage1=2000,stage2=5000' or the reference's dict literal
    "{'stage1': 2000, 'stage2': 5000}" (main_distill_mutual.py:233-238)."""
    out = {"stage1": 2000, "stage2": 5000}
    if text:
        text = text.strip("{} ")
        for part in text.replace("'", "").replace('"', "").split(","):
            if not part:
                continue
            k, v = part.split("=") if "=" in part else part.split(":")
            out[k.strip()] = int(v)
    return out


def parse_args(argv=None):
    """(args, the run's PVDConfig) of the command line."""
    parser = base_parser(distill=True)
    parser.add_argument("--stage_iters", type=str, default="",
                        help="stage1=2000,stage2=5000")
    parser.add_argument("--test_type_trainval", action="store_true")
    parser.add_argument("--load_args", type=str, default="")
    args = parser.parse_args(argv)
    cfg = to_config(args)
    if args.load_args:
        # a previous run's args.json (the reference's load_from_txt)
        with open(args.load_args) as f:
            cfg = PVDConfig.from_json(f.read().split("\n//")[0])
    stages = parse_stage_iters(args.stage_iters)
    cfg.stage1_iters = stages["stage1"]
    cfg.stage2_iters = stages["stage2"]
    return args, cfg


def main(argv=None, device="cuda") -> dict:
    """Run the CLI on `argv` (sys.argv's by default); returns the final
    stats."""
    args, cfg = parse_args(argv)
    seed_everything(cfg.seed)
    trainer = Trainer(cfg, mode="distill", device=device)

    if args.test or args.test_teacher or args.test_type_trainval:
        if cfg.ckpt_teacher:
            trainer.load_teacher(cfg.ckpt_teacher)
        if not args.test_teacher:
            if cfg.ckpt_student:
                trainer.load_student(cfg.ckpt_student)
            else:
                trainer.try_resume()
        split = "trainval" if args.test_type_trainval else "test"
        ds = NeRFDataset(cfg, split, downscale=cfg.downscale)
        # the reference refreshes the student's grid before test rendering
        # only under update_stu_extra (distill_mutual/utils.py:1227-1232)
        return trainer.evaluate(ds, use_teacher=args.test_teacher,
                                write_video=True,
                                refresh_occ=cfg.update_stu_extra
                                and not args.test_teacher)

    if not cfg.ckpt_teacher:
        raise SystemExit("--ckpt_teacher is required for distillation")
    # the Trainer's config: it drops stage 1 when a side is 'tensors'
    if trainer.rank == 0:
        write_args_txt(trainer.cfg, cfg.workspace)
        save_codes_env(cfg.workspace)
    trainer.load_teacher(cfg.ckpt_teacher)
    if cfg.enable_edit_plenoxel and cfg.teacher_type == "tensors":
        # scene editing: erase a region of the teacher's volume before
        # distilling (network.py:313-316)
        trainer.teacher.edit_erase_region()
        trainer.log("[edit_plenoxel] teacher region erased")
    if cfg.ckpt_student:
        trainer.load_student(cfg.ckpt_student)
    elif cfg.ckpt == "latest":
        trainer.try_resume()
    # the resize schedule's resolutions (main_distill_mutual.py:367-382)
    trainer.upsample_resolutions = upsample_schedule(cfg)

    train_ds = NeRFDataset(cfg, "train", downscale=cfg.downscale)
    try:
        valid_ds = NeRFDataset(cfg, "val", downscale=cfg.downscale)
    except (FileNotFoundError, RuntimeError):
        valid_ds = None  # the scene has no val split
    trainer.train(train_ds, valid_ds=valid_ds)
    trainer.evaluate(NeRFDataset(cfg, "test", downscale=cfg.downscale),
                     write_video=True)
    finalize_run(trainer, cfg)
    return trainer.stats


if __name__ == "__main__":
    main(sys.argv[1:])
