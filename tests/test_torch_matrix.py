"""Any-to-any distillation through pvd_tpu_torch's Trainer and both CLIs
on the CPU (tests/test_distill_matrix.py on the port).

The 4 x 4 matrix of teachers and students of hash, mlp, vm and tensors at
that test's tiny config (6/1/1 views at 32 x 32, 128 rays, grid 16, 64
march steps, 24 slots per ray; the MLP 4 x 32 with PE 4 and skip 1, VM
and plenoxels at 12^3): each teacher trains 24 steps once, each pair
distills 18 (stages at 6 / 12; no stage 1 with a plenoxel side) and
renders its test view.  The teachers are too short to be good: the checks
are of the path (step counts, finite PSNR, files).  Then the teacher CLI
(on the host batcher, as its default is) and the distill CLI end to end
for the llff and tank pose samplers, the teacher CLI's `--test` reload,
and the new fields through both CLIs.
"""

import glob
import itertools
import json
import os

import numpy as np
import pytest
import torch

from pvd_tpu.cli import common as j_common
from pvd_tpu_torch.cli import common, distill, train_teacher
from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.provider import NeRFDataset
from pvd_tpu_torch.data.synth import write_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.trainer import Trainer

torch.set_num_threads(1)

ARCHS = ["hash", "mlp", "vm", "tensors"]
PAIRS = list(itertools.product(ARCHS, ARCHS))
SMALL = ["--num_rays", "128", "--grid_size", "16", "--max_steps", "64",
         "--max_samples", "24", "--density_thresh", "0.01",
         "--eval_interval", "1000"]
FIELDS = ["--resolution0", "12", "--plenoxel_res", "[12,12,12]",
          "--nerf_layer_num", "4", "--nerf_layer_wide", "32", "--PE", "4",
          "--skip", "1"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("matrix_scene"))
    return write_synthetic_scene(root, n_train=6, n_val=1, n_test=1, H=32,
                                 W=32)


def _cfg(scene, ws, **kw):
    base = dict(
        path=scene, workspace=ws, num_rays=128, grid_size=16, max_steps=64,
        max_samples=24, update_extra_interval=8, max_ray_batch=1024,
        density_thresh=0.01, seed=0,
        resolution0=12, resolution1=12, plenoxel_res=(12, 12, 12),
        nerf_layer_num=4, nerf_layer_wide=32, PE=4, skip=1,
    )
    base.update(kw)
    return PVDConfig(**base)


@pytest.fixture(scope="module")
def teacher_ckpts(scene, tmp_path_factory):
    """Each field trained as a teacher once, shared by its 4 students."""
    paths = {}
    for arch in ARCHS:
        ws = str(tmp_path_factory.mktemp(f"t_{arch}"))
        cfg = _cfg(scene, ws, model_type=arch, iters=24)
        tr = Trainer(cfg, device="cpu")
        tr.train(NeRFDataset(cfg, "train"))
        assert tr.state.step == 24
        paths[arch] = tr.save()
    return paths


@pytest.mark.parametrize("teacher,student", PAIRS)
def test_distill_pair(scene, tmp_path_factory, teacher_ckpts, teacher,
                      student):
    ws = str(tmp_path_factory.mktemp(f"s_{teacher}2{student}"))
    cfg = _cfg(scene, ws, model_type=student, teacher_type=teacher,
               iters=18, stage1_iters=6, stage2_iters=12)
    tr = Trainer(cfg, mode="distill", device="cpu")
    tr.load_teacher(teacher_ckpts[teacher])
    tr.train(NeRFDataset(cfg, "train"))
    assert tr.state.step == 18
    stats = tr.train_stats
    plenoxel = "tensors" in (teacher, student)
    assert stats["stage1_steps"] == (0 if plenoxel else 6)
    assert stats["stage3_steps"] == 6
    assert np.isfinite(tr.evaluate(NeRFDataset(cfg, "test"))["psnr"])


def _teacher_cli(scene, ws, arch, *extra):
    argv = [scene, "--workspace", ws, "--model_type", arch, "--iters", "16",
            *SMALL, *FIELDS, *extra]
    stats = train_teacher.main(argv, device="cpu")
    (done,) = glob.glob(ws + "-psnr*")
    return stats, done, argv


@pytest.mark.parametrize("data_type", ["llff", "tank"])
def test_distill_llff_tank_through_cli(scene, tmp_path, data_type):
    """tests/test_distill_matrix.py:44 on the port: a hash teacher through
    the teacher CLI (host batcher), `--test` reloads it, then the distill
    CLI with the camera-bbox (llff) or radius-randomised orbit (tank)
    pose sampler."""
    stats, done, argv = _teacher_cli(scene, str(tmp_path / "tea"), "hash")
    assert np.isfinite(stats["psnr"]) and stats["host_batcher"] is True
    assert stats["train_steps"] == 16
    with open(os.path.join(done, "metrics.json")) as f:
        assert json.load(f)["psnr"] == stats["psnr"]
    with open(os.path.join(done, "args.json")) as f:
        assert PVDConfig.from_json(f.read()).preload is False
    ckpts = sorted(glob.glob(os.path.join(done, "checkpoints", "*.ckpt")))
    assert ckpts
    argv[argv.index("--workspace") + 1] = done
    again = train_teacher.main(argv + ["--test"], device="cpu")
    # 16 steps end inside the padded warm-up: the trained Trainer renders
    # uncompacted, the reloaded one on the compacted ladder; the same
    # samples, summed in another order
    assert abs(again["psnr"] - stats["psnr"]) < 1e-4
    assert os.path.exists(os.path.join(done, "results", "hash_0000.png"))

    ws = str(tmp_path / f"dis_{data_type}")
    distill.main([scene, "--workspace", ws, "--teacher_type", "hash",
                  "--model_type", "vm", "--ckpt_teacher", ckpts[-1],
                  "--data_type", data_type, "--iters", "12",
                  "--stage_iters", "{'stage1':4,'stage2':8}", *SMALL,
                  "--resolution0", "12"], device="cpu")
    assert sorted(glob.glob(ws + "*/results/*.png"))


@pytest.mark.parametrize("tea,stu", [("mlp", "tensors"), ("tensors", "mlp")])
def test_new_fields_through_both_clis(scene, tmp_path, tea, stu):
    """The MLP and plenoxel fields as teacher (teacher CLI) and student
    (distill CLI); a plenoxel side skips stage 1, and a plenoxel teacher
    takes --enable_edit_plenoxel."""
    stats, done, _ = _teacher_cli(scene, str(tmp_path / "tea"), tea)
    assert np.isfinite(stats["psnr"])
    best = glob.glob(os.path.join(done, "checkpoints", f"{tea}_*.ckpt"))
    ws = str(tmp_path / "dis")
    argv = [scene, "--workspace", ws, "--teacher_type", tea, "--model_type",
            stu, "--ckpt_teacher", sorted(best)[-1], "--iters", "8",
            "--stage_iters", "stage1=3,stage2=5", *SMALL, *FIELDS]
    if tea == "tensors":
        argv.append("--enable_edit_plenoxel")
    out = distill.main(argv, device="cpu")
    assert np.isfinite(out["psnr"]) and out["stage1_steps"] == 0
    assert out["train_steps"] == 8
    (ddone,) = glob.glob(ws + "-psnr*")
    # args.json holds the run's config: the Trainer's, without stage 1
    with open(os.path.join(ddone, "args.json")) as f:
        cfg = PVDConfig.from_json(f.read())
    assert cfg.stage1_iters == 0 and cfg.stage2_iters == 5
    saved = ckpt.load_checkpoint(sorted(glob.glob(os.path.join(
        ddone, "checkpoints", f"{tea}2{stu}_*.ckpt")))[-1], "cpu")
    key = "volume" if stu == "tensors" else "nerf_mlp"
    assert key in saved["params"]


def test_teacher_cli_refuses_resizing(scene, tmp_path):
    """--upsample_model_steps together with --ema_decay is refused: the
    JAX package resizes the field but not its EMA weights (ROADMAP C10).
    Resizing alone runs (tests/test_torch_resize.py and chip_smoke.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP C10"):
        train_teacher.main([scene, "--workspace", str(tmp_path / "w"),
                            "--model_type", "vm", "--upsample_model_steps",
                            "5", "--ema_decay", "0.9", *SMALL], device="cpu")


def test_new_flags_to_config_match_jax(scene):
    """The fields' flags land in the same PVDConfig values as the JAX
    CLI's, and in the ModelSpec."""
    argv = [scene, *FIELDS, "--plenoxel_degree", "2",
            "--enable_edit_plenoxel", "--model_type", "tensors"]
    want = j_common.to_config(j_common.base_parser(False).parse_args(argv))
    got = common.to_config(common.base_parser(False).parse_args(argv))
    for k, v in json.loads(got.to_json()).items():
        assert json.loads(want.to_json())[k] == v, k
    spec, spec_j = got.model_spec(), want.model_spec()
    for k in ("pe_multires", "nerf_layer_num", "nerf_layer_wide", "skip",
              "plenoxel_degree", "plenoxel_res", "dir_sh_degree",
              "plenoxel_fea_dim"):
        assert tuple(np.atleast_1d(getattr(spec, k))) == \
            tuple(np.atleast_1d(getattr(spec_j, k))), k
