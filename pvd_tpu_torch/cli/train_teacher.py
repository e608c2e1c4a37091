"""Teacher training CLI (port of pvd_tpu/cli/train_teacher.py; the
reference's main_just_train_tea.py).

Usage:
  python -m pvd_tpu_torch.cli.train_teacher <data_path> --model_type hash \
      --workspace ws_hash [--iters 40000 --num_rays 8192 ...]
  python -m pvd_tpu_torch.cli.train_teacher <data_path> --test \
      --workspace ws_hash-psnrXX.XX

Training reads the blender-format scene at <data_path> (train, val when
the scene has it, test), trains a field of any `--model_type` (hash, mlp,
vm, tensors), resuming from the workspace's latest checkpoint under
`--ckpt latest`, evaluates the test split into `<workspace>/results` and
writes `metrics.json`, then renames the workspace with its PSNR suffix.
Without `--preload` (the default) the batches come from the host batcher
(`data/raybatch.py`); with it the images live on the device.  `--test`
renders the test split again from the workspace's latest checkpoint (or
`--ckpt_student`).  `--upsample_model_steps` resizes a VM or plenoxel
field after each listed step, to resolutions log-spaced from
`--resolution0` to `--resolution1` (`common.upsample_schedule`; a VM
field first shrinks to its occupied box); `--error_map` draws the pixels
by importance from a per-image error map; `--ema_decay` > 0 keeps an EMA
of the weights, which the evaluations render and the best checkpoint
holds.  Runs on the GPU; `main(argv, device="cpu")` runs the plain
PyTorch path on the CPU.
"""

from __future__ import annotations

import sys

from pvd_tpu_torch.cli.common import (base_parser, finalize_run, to_config,
                                      upsample_schedule, write_args_txt)
from pvd_tpu_torch.data.provider import NeRFDataset
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.utils.misc import seed_everything


def parse_args(argv=None):
    """(args, the run's PVDConfig) of the command line."""
    args = base_parser(distill=False).parse_args(argv)
    return args, to_config(args)


def main(argv=None, device="cuda") -> dict:
    """Run the CLI on `argv` (sys.argv's by default); returns the final
    stats."""
    args, cfg = parse_args(argv)
    seed_everything(cfg.seed)
    trainer = Trainer(cfg, mode="teacher", device=device)

    if args.test:
        if not trainer.try_resume() and cfg.ckpt_student:
            trainer.load_student(cfg.ckpt_student)
        # the reference refreshes the grid before test rendering only under
        # update_stu_extra (just_train_tea/utils.py:1204-1211)
        return trainer.evaluate(
            NeRFDataset(cfg, "test", downscale=cfg.downscale),
            write_video=True, refresh_occ=cfg.update_stu_extra)

    write_args_txt(cfg, cfg.workspace)
    train_ds = NeRFDataset(cfg, "train", downscale=cfg.downscale)
    if cfg.ckpt == "latest":
        trainer.try_resume()
    # the resize schedule's resolutions (main_just_train_tea.py:320-334)
    trainer.upsample_resolutions = upsample_schedule(cfg)
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
