"""The port's Trainer with scan steps against the JAX package's, on the
CPU.

A VM teacher (24^3, f32 heads; 512 rays of 32x32 views, grid 16, 64
march steps, the padded path) trained for 96 steps with scan_steps=4 by
each package's Trainer from the same seed, then a VM student distilled
from it (stages 16 / 40 of 96 steps, scan_steps=4); each scored by its
own package's `evaluate` on the test views.  Every chunk that the
schedule allows runs as one K-step call (tests/test_torch_scan.py holds
the schedule and the calls against JAX's).  Tolerance: test PSNR within
1.0 dB, as tests/test_torch_quality_witness.py holds the single-step
Trainers: the steps match JAX's given the same rays, but the two packages
draw their rays from different generators.
"""

import numpy as np
import pytest
import torch

from pvd_tpu.engine.trainer import Trainer as JTrainer
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.trainer import Trainer

torch.set_num_threads(1)

WITNESS = dict(model_type="vm", resolution0=24, num_rays=512, grid_size=16,
               max_steps=64, max_samples=24, samples_per_ray=0.0,
               autotune_budget=False, precision="fp32", iters=96,
               update_extra_interval=16, density_thresh=0.01, lr=2e-2,
               scan_steps=4, preload=True, eval_interval=10 ** 6, seed=0)
WITNESS_SCENE = dict(n_train=6, n_val=1, n_test=2, H=32, W=32)
TOL_TRAIN_PSNR = 1.0


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    """Test PSNR of each package's VM teacher and of its VM student
    (stages 16 / 40 of 96 steps), each Trainer with scan_steps=4."""
    from pvd_tpu.config import PVDConfig as JCfg
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene

    root = j_make_scene(str(tmp_path_factory.mktemp("scene")),
                        **WITNESS_SCENE)
    dkw = dict(WITNESS, teacher_type="vm", stage1_iters=16, stage2_iters=40)
    out = {}
    jcfg = JCfg(path=root, workspace=str(tmp_path_factory.mktemp("jt")),
                **WITNESS)
    jt = JTrainer(jcfg, mode="teacher")
    jt.train(NeRFDataset(jcfg, "train"))
    j_test = NeRFDataset(jcfg, "test")
    out["jax", "teacher"] = jt.evaluate(j_test)["psnr"]
    j_tea = jt.save()
    jcfg_d = JCfg(path=root, workspace=str(tmp_path_factory.mktemp("js")),
                  **dkw)
    js = JTrainer(jcfg_d, mode="distill")
    js.load_teacher(j_tea)
    js.train(NeRFDataset(jcfg_d, "train"))
    out["jax", "student"] = js.evaluate(j_test)["psnr"]

    scene = make_synthetic_scene(**WITNESS_SCENE)
    pt = Trainer(PVDConfig(**WITNESS, workspace=str(
        tmp_path_factory.mktemp("pt"))), device="cpu")
    pt.train(scene["train"])
    out["torch", "teacher"] = pt.evaluate(scene["test"])["psnr"]
    ps = Trainer(PVDConfig(**dkw, workspace=str(
        tmp_path_factory.mktemp("ps"))), mode="distill", device="cpu")
    ps.load_teacher(pt.save())
    ps.train(scene["train"])
    out["torch", "student"] = ps.evaluate(scene["test"])["psnr"]
    print(f"[witness] {out}", flush=True)
    return out


@pytest.mark.parametrize("role", ["teacher", "student"])
def test_scan_trainer_ends_where_jax_does(witness, role):
    got, want = witness["torch", role], witness["jax", role]
    assert np.isfinite(got) and got > 12.0, witness
    assert abs(got - want) < TOL_TRAIN_PSNR, witness
