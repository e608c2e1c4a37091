"""pvd_tpu_torch's teacher Trainer on the CPU.

A short run at the settings of tests/test_train_integration.py:_cfg
(220 steps, 512 rays, grid 32, 128 march steps, 48 slots per ray) on the
48x48 synthetic scene with 10 training views, through `Trainer.train`.
All 220 steps fall in the uncompacted warmup (16 x 16 = 256 steps), so the
run trains on the padded path.  Its test PSNR, rendered with the eval
renderer against white-composited GT (as the JAX `Trainer.evaluate`
does), must beat the JAX test's floor of 14 dB; predicting the white
background alone gives ~10 dB on this scene.
"""

import os

import numpy as np
import pytest
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.utils.metrics import PSNRMeter

torch.set_num_threads(1)

CFG = dict(iters=220, num_rays=512, grid_size=32, max_steps=128,
           max_samples=48, update_extra_interval=16, max_ray_batch=2048,
           density_thresh=0.01, lr=1e-2, seed=0)
PSNR_FLOOR = 14.0


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=10, n_val=1, n_test=2, H=48, W=48)


@pytest.fixture(scope="module")
def run(scene, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws_teacher"))
    trainer = Trainer(PVDConfig(**CFG, workspace=ws), device="cpu")
    trainer.train(scene["train"])
    return trainer


def test_teacher_training_reaches_the_psnr_floor(run, scene):
    test = scene["test"]
    meter = PSNRMeter()
    for pose, img in zip(test.poses, test.images):
        out = run.eval_render(run.state.field, run.state.occ, pose,
                              test.intrinsics, test.H, test.W)
        gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        assert np.isfinite(out.image.numpy()).all()
        meter.update(out.image.numpy(), gt)
    assert meter.measure() > PSNR_FLOOR, meter.report()


def test_run_bookkeeping(run):
    """220 steps, all in the padded warmup; the grid went through its 14
    full sweeps; the batch PSNR rose."""
    assert run.state.step == 220 and len(run.history) == 220
    assert run.rspec.samples_per_ray == 0.0 and run._warmup_spr == 16.0
    assert run.state.occ.iter_density == 14
    assert not (run.state.occ.density_grid == -1).all()
    first = np.mean([float(m["psnr"]) for m in run.history[:16]])
    last = np.mean([float(m["psnr"]) for m in run.history[-16:]])
    assert last > first + 5.0
    stats = run.train_stats
    assert stats["train_steps"] == stats["padded_steps"] == 220
    assert stats["compacted_steps"] == 0
    assert stats["occ_full_updates"] == 14 and stats["occ_partial_updates"] == 0
    assert stats["train_rays_per_sec"] > 0 and stats["train_occ_s"] > 0
    assert stats["padded_ms_per_step"] > 0 and stats["occ_full_ms"] > 0


def test_warmup_ends_with_the_sample_budget(scene, tmp_path):
    """The first autotune tick after the warmup turns the compacted path
    on (interval 1 keeps it short: 16 warmup steps)."""
    cfg = PVDConfig(**{**CFG, "iters": 18, "update_extra_interval": 1},
                    workspace=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    trainer.train(scene["train"])
    assert trainer._warmup_spr == 0.0 and trainer.rspec.samples_per_ray > 0
    assert "compact_frac" not in trainer.history[15]
    assert "compact_frac" in trainer.history[16]
    assert trainer.state.occ.iter_density == 18  # 16 full, 2 partial
    stats = trainer.train_stats
    assert (stats["padded_steps"], stats["compacted_steps"]) == (16, 2)
    assert (stats["occ_full_updates"], stats["occ_partial_updates"]) == (16, 2)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(model_type="vm", ema_decay=0.95,
                      upsample_model_steps=(5,)), id="ema_decay"),
    pytest.param(dict(error_map=True, scan_steps=4), id="error_map"),
    dict(scan_steps=4), dict(n_devices=2),
    pytest.param(dict(model_type="tensors", ema_decay=0.95,
                      upsample_model_steps=(5,)),
                 id="upsample_model_steps")],
    ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw):
    """Scan steps (A16) and data parallelism (A17) are not ported; EMA
    together with resizing is refused (C10: the JAX package resizes the
    field but not its EMA weights).  EMA, the error map and resizing
    alone are taken (tests/test_torch_error_map.py,
    tests/test_torch_resize.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(PVDConfig(**kw), device="cpu")


def test_wall_budget_ends_at_an_epoch_boundary(scene, tmp_path):
    """A spent wall budget ends training at the next epoch boundary (one
    epoch of the 10 training views here), with the final checkpoint and
    the eval that writes the best one (trainer.py:962-983)."""
    cfg = PVDConfig(**{**CFG, "iters": 100}, wall_budget=1e-6,
                    workspace=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    trainer.train(scene["train"], valid_ds=scene["val"])
    assert trainer.state.step == len(scene["train"]) == 10
    assert trainer.train_stats["train_steps"] == 10
    ck = tmp_path / "checkpoints"
    assert (ck / "hash_step00000010.ckpt").exists()
    assert (ck / "hash_best.ckpt").exists()


def test_unported_modes_and_methods_raise(scene, tmp_path):
    """Distillation raises for scan steps, data parallelism and EMA
    together with resizing, whatever the pair; evaluate writes each view's
    image and depth PNG, and a video only where imageio has a codec."""
    for kw in (dict(model_type="vm", ema_decay=0.9,
                    upsample_model_steps=(5,)),
               dict(model_type="mlp", teacher_type="tensors",
                    scan_steps=4),
               dict(model_type="vm", n_devices=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(PVDConfig(**kw), mode="distill", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        Trainer(PVDConfig(), mode="serve", device="cpu")
    tr = Trainer(PVDConfig(**CFG, workspace=str(tmp_path)), device="cpu")
    test = scene["test"]
    stats = tr.evaluate(test, save_dir=str(tmp_path / "out"),
                        write_video=True)
    names = sorted(os.listdir(tmp_path / "out"))
    pngs = [f"hash_{i:04d}{s}.png" for i in range(len(test))
            for s in ("", "_depth")]
    assert set(pngs) <= set(names)
    assert set(names) - set(pngs) <= {"hash_video.mp4",
                                      "hash_video_depth.mp4"}
    assert stats["lpips_proxy"] > 0 and "lpips_alex" not in stats
    assert not tr.try_resume()  # nothing saved in a fresh workspace
