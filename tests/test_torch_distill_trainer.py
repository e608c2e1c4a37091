"""pvd_tpu_torch's Trainer in distill mode, through a checkpoint file, on
the CPU (tests/test_train_integration.py:72-98 of the JAX package).

A cell-mode hash teacher (the full INGP width with 9 cell levels, as the
JAX package's quality recipe trains it) at the settings of
tests/test_torch_trainer.py (512 rays, grid 32, 128 march steps, 48 slots
per ray), but 160 steps to keep the file near 80 s on one thread (it
reaches ~18 dB), on the 48x48 synthetic scene with 10 training views; `save`, then `Trainer(mode="distill").load_teacher(path)` and 70
steps of a VM student at resolution 24 and 256 rays across all three
stages (20 / 20 / 30).  The teacher must beat 14 dB on the test views
before and after the reload (predicting the white background alone gives
~10 dB); the student's eval must be finite.
"""

import os

import numpy as np
import pytest
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.params import hash_tree_from_field

torch.set_num_threads(1)

CFG = dict(iters=160, num_rays=512, grid_size=32, max_steps=128,
           max_samples=48, update_extra_interval=16, max_ray_batch=2048,
           density_thresh=0.01, lr=1e-2, seed=0, hash_cell_levels=9)
DISTILL = dict(model_type="vm", teacher_type="hash", iters=70,
               stage1_iters=20, stage2_iters=40, num_rays=256,
               resolution0=24)
PSNR_FLOOR = 14.0


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=10, n_val=1, n_test=2, H=48, W=48)


@pytest.fixture(scope="module")
def teacher(scene, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws_teacher"))
    trainer = Trainer(PVDConfig(**CFG, workspace=ws), device="cpu")
    trainer.train(scene["train"], valid_ds=scene["val"])
    return trainer


@pytest.fixture(scope="module")
def student(teacher, scene, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws_distill"))
    path = ckpt.latest_checkpoint(os.path.join(teacher.workspace,
                                               "checkpoints"), "hash")
    trainer = Trainer(PVDConfig(**{**CFG, **DISTILL}, workspace=ws),
                      mode="distill", device="cpu")
    trainer.load_teacher(path)
    trainer.train(scene["train"])
    return trainer, path


def test_cell_teacher_trains_and_checkpoints(teacher, scene):
    field = teacher.state.field
    assert tuple(field.encoder_cell.shape) == (589_824, 16)
    assert tuple(field.encoder.shape) == (585_112, 2)
    stats = teacher.evaluate(scene["test"])
    assert stats["psnr"] > PSNR_FLOOR, stats
    assert 0.0 < stats["ssim"] <= 1.0 and stats["eval_s_per_image"] > 0
    ck = os.path.join(teacher.workspace, "checkpoints")
    payload = ckpt.load_checkpoint(ckpt.latest_checkpoint(ck, "hash"), "cpu")
    assert payload["step"] == CFG["iters"]
    tree = hash_tree_from_field(field)
    for k in ("encoder", "encoder_cell"):
        np.testing.assert_array_equal(payload["params"][k], tree[k])
    # the val eval at the end of training wrote the best checkpoint
    best = ckpt.load_checkpoint(os.path.join(ck, "hash_best.ckpt"), "cpu")
    assert best["step"] == CFG["iters"] and best["stats"]["psnr"] == teacher.best_psnr


def test_distill_hash_to_vm_all_stages(student, teacher, scene):
    trainer, path = student
    assert trainer.state.step == 70 and len(trainer.history) == 70
    hist = trainer.history
    assert "loss_sigma" not in hist[19] and "loss_sigma" in hist[20]
    assert "loss_rgb" not in hist[39] and "loss_rgb" in hist[40]
    stats = trainer.train_stats
    assert [stats[f"stage{s}_steps"] for s in (1, 2, 3)] == [20, 20, 30]
    assert stats["occ_full_updates"] == stats["occ_partial_updates"] == 0
    # the student inherited the teacher's grid and did not refresh it
    assert torch.equal(trainer.state.occ.bitfield,
                       teacher.state.occ.bitfield)
    # the frozen teacher is the checkpoint's, and its quality survives
    for k, v in hash_tree_from_field(trainer.teacher).items():
        if k.startswith("encoder"):
            np.testing.assert_array_equal(
                v, hash_tree_from_field(teacher.state.field)[k])
    assert not any(p.requires_grad for p in trainer.teacher.parameters())
    st = trainer.evaluate(scene["test"])
    assert np.isfinite(st["psnr"]) and np.isfinite(st["ssim"])
    st_tea = trainer.evaluate(scene["test"], use_teacher=True)
    assert st_tea["psnr"] > PSNR_FLOOR, st_tea


def test_load_teacher_warm_starts_student(student, tmp_path):
    """`load_teacher` hands the student the frozen teacher's color head
    (the one head both fields share) and keeps the student's own VM
    planes, lines and basis."""
    _, path = student
    cfg = PVDConfig(**{**CFG, **DISTILL}, workspace=str(tmp_path))
    trainer = Trainer(cfg, mode="distill", device="cpu")
    before = {k: v.clone() for k, v in trainer.state.field.state_dict()
              .items()}
    trainer.load_teacher(path)
    stu, tea = trainer.state.field, trainer.teacher
    for a, b in zip(stu.color_net, tea.color_net):
        assert torch.equal(a.weight, b.weight)
    copied = {f"color_net.{k}" for k in tea.color_net.state_dict()}
    assert copied <= set(before)
    for k, v in stu.state_dict().items():
        if k not in copied:
            assert torch.equal(v, before[k]), k
    assert any(not torch.equal(stu.state_dict()[k], before[k])
               for k in copied)


def test_distill_checkpoint_and_resume(student):
    """The student's last checkpoint resumes a fresh distill Trainer at its
    step, with the VM tables it had."""
    trainer, _ = student
    fresh = Trainer(trainer.cfg, mode="distill", device="cpu")
    assert fresh.try_resume() and fresh.state.step == 70
    for a, b in zip(fresh.state.field.parameters(),
                    trainer.state.field.parameters()):
        assert torch.equal(a, b)
