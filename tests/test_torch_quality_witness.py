"""The port's Trainer and evaluate against the JAX package's, on the CPU.

Both packages' Trainers train the same cell-mode hash teacher (the full
INGP width with 9 cell levels, as the JAX package's quality recipe
tools/quality_ab.py trains it) from the same seed and settings: those of
tests/test_torch_distill_trainer.py (512 rays, grid 32, 128 march steps,
48 slots per ray, 160 steps on the 48x48 synthetic scene with 10 training
views), but with an occupancy update every 8 steps, so that the padded
warm-up ends at step 128 and the last 32 steps run compacted and
autotuned, as most of the recipe's steps do.  The JAX side reads the scene
as the recipe does (PNG files written by its make_synthetic_scene, read
back by NeRFDataset); the port uses its in-memory scene, which equals that
read-back (tests/test_torch_teacher.py).  Then each package's `evaluate`
scores both teachers on the test views.

- Same field, both evaluates: PSNR within 0.01 dB and SSIM within 5e-4.
  The march is exact between the packages; the bf16 heads round in other
  orders (seen: 7e-4 dB and 6e-5 SSIM).
- Same recipe, both Trainers: test PSNR within 1.0 dB of each other.  The
  steps match JAX's to 2e-5 given the same rays
  (tests/test_torch_teacher.py), but the two Trainers draw their rays
  from different generators (torch's against JAX's keys), which moves the
  PSNR of a 160-step run by a few tenths of a dB (seen: 0.09 dB).
"""

import os

import numpy as np
import pytest
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.trainer import Trainer

torch.set_num_threads(1)

CFG = dict(iters=160, num_rays=512, grid_size=32, max_steps=128,
           max_samples=48, update_extra_interval=8, max_ray_batch=2048,
           density_thresh=0.01, lr=1e-2, seed=0, hash_cell_levels=9)
SCENE = dict(n_train=10, n_val=1, n_test=2, H=48, W=48)
TOL_EVAL_PSNR, TOL_EVAL_SSIM, TOL_TRAIN_PSNR = 0.01, 5e-4, 1.0


@pytest.fixture(scope="module")
def scores(tmp_path_factory):
    """PSNR/SSIM of each package's teacher under each package's evaluate:
    {(trained_by, evaluated_by): stats}."""
    from pvd_tpu.config import PVDConfig as JCfg
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene
    from pvd_tpu.engine.trainer import Trainer as JTrainer

    root = j_make_scene(str(tmp_path_factory.mktemp("scene")), **SCENE)
    jcfg = JCfg(path=root, workspace=str(tmp_path_factory.mktemp("ws_jax")),
                **CFG)
    jax_tr = JTrainer(jcfg, mode="teacher")
    jax_tr.train(NeRFDataset(jcfg, "train"))
    j_test = NeRFDataset(jcfg, "test")
    j_ckpt = ckpt.latest_checkpoint(
        os.path.join(jcfg.workspace, "checkpoints"), "hash")

    scene = make_synthetic_scene(**SCENE)
    pt_tr = Trainer(PVDConfig(
        **CFG, workspace=str(tmp_path_factory.mktemp("ws_torch"))),
        device="cpu")
    pt_tr.train(scene["train"])
    p_ckpt = ckpt.latest_checkpoint(
        os.path.join(pt_tr.workspace, "checkpoints"), "hash")

    def brief(st):
        return {"psnr": st["psnr"], "ssim": st["ssim"]}

    out = {("jax", "jax"): brief(jax_tr.evaluate(j_test)),
           ("torch", "torch"): brief(pt_tr.evaluate(scene["test"]))}
    jax_tr.load_student(p_ckpt)
    out["torch", "jax"] = brief(jax_tr.evaluate(j_test))
    pt_tr.load_student(j_ckpt)
    out["jax", "torch"] = brief(pt_tr.evaluate(scene["test"]))
    print({f"{a} teacher, {b} evaluate": v for (a, b), v in out.items()})
    return out


@pytest.mark.parametrize("trained_by", ["jax", "torch"])
def test_evaluate_matches_jax_on_the_same_field(scores, trained_by):
    ours, ref = scores[trained_by, "torch"], scores[trained_by, "jax"]
    assert abs(ours["psnr"] - ref["psnr"]) <= TOL_EVAL_PSNR, (ours, ref)
    assert abs(ours["ssim"] - ref["ssim"]) <= TOL_EVAL_SSIM, (ours, ref)


def test_trainer_reaches_jax_quality(scores):
    ours, ref = scores["torch", "torch"], scores["jax", "jax"]
    assert np.isfinite(ours["psnr"]) and ref["psnr"] > 14.0, (ours, ref)
    assert abs(ours["psnr"] - ref["psnr"]) <= TOL_TRAIN_PSNR, (ours, ref)
