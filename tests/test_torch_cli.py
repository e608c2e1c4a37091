"""pvd_tpu_torch's distillation CLI on the CPU (`main(argv, device="cpu")`)
against the JAX package's CLI, and the Trainer pieces it brings back.

A scene written to disk by the port's writer (6/1/1 views at 32x32); hash
teachers trained by the port's Trainer at the settings of
tests/test_distill_matrix.py:44 (16 steps of 128 rays, grid 16, 64 march
steps, 24 slots per ray), exact and cell-mode; then the CLI distills a VM
student at resolution 12 for 12 steps through stages 1-3, writes
`results/*.png` and `metrics.json`, renames the workspace, and `--test`
/ `--test_teacher` render it again.  The teachers are too short to be
good: the checks are of the path (finite PSNR, files, the reloaded
student rendering the same PSNR to 1e-9 dB, CPU runs being
deterministic).

Against the JAX package: the parser (flags, defaults, help), `to_config`,
`parse_stage_iters`, and the two Trainer pieces:
`evaluate(refresh_occ=True)` (density grid to rtol 1e-4 with the JAX
draws, bits exact off the threshold; tests/test_torch_large_scene.py's
tolerances) and `load_student`'s switch to the checkpoint's VM resolution.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.cli import common as j_common
from pvd_tpu.cli import distill as j_distill
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.engine.trainer import Trainer as JTrainer
from pvd_tpu_torch.cli import common, distill
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.png import read_png
from pvd_tpu_torch.data.provider import NeRFDataset
from pvd_tpu_torch.data.synth import write_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine import trainer as trainer_mod
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.vm_field import VMField
from pvd_tpu_torch.params import vm_tree_from_field

torch.set_num_threads(1)

SMALL = ["--num_rays", "128", "--grid_size", "16", "--max_steps", "64",
         "--max_samples", "24"]
TEACHER = dict(num_rays=128, grid_size=16, max_steps=64, max_samples=24,
               density_thresh=0.01, iters=16, eval_interval=1000)
GRID_RTOL = 1e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_scene"))
    return write_synthetic_scene(root, n_train=6, n_val=1, n_test=1, H=32,
                                 W=32)


@pytest.fixture(scope="module")
def teachers(scene, tmp_path_factory):
    """An exact and a cell-mode hash teacher, trained by the port's Trainer
    on the scene as the reader gives it; their last checkpoints."""
    paths = {}
    for cell in (0, 9):
        ws = str(tmp_path_factory.mktemp(f"cli_tea{cell}"))
        cfg = PVDConfig(path=scene, workspace=ws, hash_cell_levels=cell,
                        **TEACHER)
        tr = Trainer(cfg, device="cpu")
        tr.train(NeRFDataset(cfg, "train"))
        paths[cell] = tr.save()
    return paths


def _distill_argv(scene, ws, ckpt_teacher, *extra):
    return [scene, "--workspace", ws, "--teacher_type", "hash",
            "--model_type", "vm", "--ckpt_teacher", ckpt_teacher,
            "--iters", "12", "--stage_iters", "stage1=4,stage2=8",
            "--resolution0", "12", "--eval_interval", "1000", *SMALL,
            *extra]


@pytest.mark.parametrize("cell,bake", [(9, True), (0, True), (9, False)],
                         ids=["cell9-baked", "cell0-baked", "cell9-exact"])
def test_distill_cli_trains_writes_and_tests(scene, teachers, tmp_path, cell,
                                            bake):
    ws = str(tmp_path / "h2v")
    extra = ["--hash_cell_levels", str(cell)] + (["--hash_bake_dense"]
                                                 if bake else [])
    stats = distill.main(_distill_argv(scene, ws, teachers[cell], *extra),
                         device="cpu")
    assert np.isfinite(stats["psnr"]) and stats["train_steps"] == 12
    assert stats["lpips_proxy"] > 0
    (done,) = glob.glob(ws + "-psnr*")
    assert done == f"{ws}-psnr{stats['psnr']:.2f}"
    with open(os.path.join(done, "metrics.json")) as f:
        assert json.load(f)["psnr"] == stats["psnr"]
    with open(os.path.join(done, "args.json")) as f:
        assert PVDConfig.from_json(f.read()).hash_bake_dense == bake
    for name in ("hash2vm_0000.png", "hash2vm_0000_depth.png"):
        img = read_png(os.path.join(done, "results", name))
        assert img.shape[:2] == (32, 32)
    assert os.path.isdir(os.path.join(done, "codes_env", "pvd_tpu_torch",
                                      "cli"))
    assert glob.glob(os.path.join(done, "checkpoints", "hash2vm_*.ckpt"))
    # --test reloads the student from the renamed workspace
    argv = _distill_argv(scene, done, teachers[cell], *extra)
    again = distill.main(argv + ["--test"], device="cpu")
    assert abs(again["psnr"] - stats["psnr"]) < 1e-9
    tea = distill.main(argv + ["--test_teacher"], device="cpu")
    assert np.isfinite(tea["psnr"])


def test_distill_cli_load_args(scene, teachers, tmp_path):
    """--load_args takes the whole config from a run's args.json: the
    positional path given here is not read."""
    ws = str(tmp_path / "h2v")
    distill.main(_distill_argv(scene, ws, teachers[9], "--hash_cell_levels",
                               "9", "--hash_bake_dense"), device="cpu")
    (done,) = glob.glob(ws + "-psnr*")
    stats = distill.main(["no_such_scene", "--load_args",
                          os.path.join(done, "args.json"),
                          "--test_teacher"], device="cpu")
    assert np.isfinite(stats["psnr"])
    with pytest.raises(FileNotFoundError):
        distill.main(["no_such_scene", "--test_teacher", "--ckpt_teacher",
                      teachers[9], "--hash_cell_levels", "9",
                      "--model_type", "vm", *SMALL], device="cpu")


@pytest.mark.parametrize("data_type", ["llff", "tank"])
def test_distill_llff_tank_through_cli(scene, teachers, tmp_path, data_type):
    """tests/test_distill_matrix.py:44 on the port: per-epoch random poses
    from the camera-bbox (llff) and radius-randomised orbit (tank)
    samplers, through the CLI, with the reference's dict-literal
    --stage_iters."""
    ws = str(tmp_path / f"dis_{data_type}")
    argv = _distill_argv(scene, ws, teachers[0], "--data_type", data_type)
    argv[argv.index("--stage_iters") + 1] = "{'stage1':4,'stage2':8}"
    distill.main(argv, device="cpu")
    assert sorted(glob.glob(ws + "*/results/*.png"))


def _parser_table(parser):
    return [(a.option_strings, a.dest, a.default, a.help, a.choices,
             a.type, a.nargs) for a in parser._actions]


@pytest.mark.parametrize("distill_mode", [True, False],
                         ids=["distill", "teacher"])
def test_parser_matches_jax(distill_mode):
    assert _parser_table(common.base_parser(distill_mode)) == \
        _parser_table(j_common.base_parser(distill_mode))


def test_to_config_matches_jax(scene):
    """The same argv gives the same values in every field the port has;
    --num_steps and --upsample_steps (once refused) load in both CLIs'
    parsers and reach the RenderSpec as in the JAX package."""
    argv = [scene, "--iters", "77", "--hash_cell_levels", "9",
            "--hash_bake_dense", "--no_autotune_budget", "--ckpt", "scratch",
            "--downscale", "2", "--resolution1", "400", "--wall_budget",
            "30", "--upsample_model_steps", "5", "--model_type", "vm",
            "--PE", "6", "--nerf_layer_wide", "64", "--skip", "2",
            "--plenoxel_res", "[10,12,14]", "--plenoxel_degree", "2",
            "--enable_edit_plenoxel"]
    want = j_common.to_config(j_common.base_parser(True).parse_args(argv))
    got = common.to_config(common.base_parser(True).parse_args(argv))
    for k, v in json.loads(got.to_json()).items():
        assert json.loads(want.to_json())[k] == v, k
    for distill_mode in (True, False):
        argv = [scene, "--num_steps", "64", "--upsample_steps", "16"]
        want = j_common.to_config(
            j_common.base_parser(distill_mode).parse_args(argv))
        got = common.to_config(
            common.base_parser(distill_mode).parse_args(argv))
        assert (got.num_steps, got.upsample_steps) == (64, 16) == (
            want.num_steps, want.upsample_steps)
        rs = got.render_spec()
        assert (rs.num_steps, rs.upsample_steps) == (64, 16)


@pytest.mark.parametrize("text", ["", "stage1=10,stage2=20",
                                  "{'stage1': 3, 'stage2': 9}",
                                  '{"stage1":1}'])
def test_parse_stage_iters_matches_jax(text):
    assert distill.parse_stage_iters(text) == j_distill.parse_stage_iters(
        text)


def _vm_checkpoint(ws, res, occ):
    spec = ModelSpec(model_type="vm", vm_resolution=res)
    field = VMField(spec, "cpu", torch.Generator().manual_seed(0))
    return ckpt.save_checkpoint(ws, "hash2vm", 5, vm_tree_from_field(field),
                                occ)


def test_load_student_takes_the_checkpoint_vm_resolution(tmp_path):
    """A student checkpoint at another VM resolution than the config's
    loads at the checkpoint's, as the JAX Trainer reads it from the plane
    and line shapes; the port's renderers follow."""
    kw = dict(model_type="vm", resolution0=16, grid_size=16,
              workspace=str(tmp_path))
    tr = Trainer(PVDConfig(**kw), mode="distill", device="cpu")
    path = _vm_checkpoint(str(tmp_path), (10, 12, 14), tr.state.occ)
    tr.load_student(path)
    j = JTrainer(JPVDConfig(**kw, tensorboard=False), mode="distill")
    j.load_student(path)
    assert tuple(tr.spec_stu.vm_resolution) == tuple(j.vm_resolution)
    assert tuple(tr.spec_stu.vm_resolution) != (16, 16, 16)
    assert tr.state.step == 5

    class View:  # one 8x8 view
        poses = np.stack([np.eye(4, dtype=np.float32)])
        poses[0, 2, 3] = 3.0
        images = None
        intrinsics = np.array([8.0, 8.0, 4.0, 4.0], np.float32)
        H = W = 8

        def __len__(self):
            return 1

    tr.evaluate(View(), save_dir=str(tmp_path / "res"))
    assert os.path.exists(tmp_path / "res" / "hash2vm_0000.png")


def test_evaluate_refresh_occ_matches_jax(tmp_path, monkeypatch):
    """evaluate(refresh_occ=True) runs one full occupancy update of the
    student from its params before rendering, as the JAX Trainer does; the
    port draws the JAX package's jitter (PRNGKey(0), fold_in per cascade)
    for the comparison."""
    kw = dict(model_type="vm", resolution0=12, grid_size=16,
              workspace=str(tmp_path))
    tr = Trainer(PVDConfig(**kw), mode="distill", device="cpu")
    path = _vm_checkpoint(str(tmp_path), (12, 12, 12), tr.state.occ)
    tr.load_student(path)
    j = JTrainer(JPVDConfig(**kw, tensorboard=False), mode="distill")
    j.load_student(path)
    key = jax.random.PRNGKey(0)
    jitter = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, cas), (16 ** 3, 3))) for cas in range(1)]))
    monkeypatch.setattr(trainer_mod, "draw_occ_inputs",
                        lambda gen, occ, rspec, full: (jitter, None))

    class Empty:
        poses, images = np.zeros((0, 4, 4), np.float32), None

        def __len__(self):
            return 0

    before = tr.state.occ.density_grid.clone()
    tr.evaluate(Empty(), refresh_occ=True)
    j.evaluate(Empty(), refresh_occ=True)
    got, want = tr.state.occ, j.state.occ
    assert not torch.equal(got.density_grid, before)
    np.testing.assert_allclose(got.density_grid.numpy(),
                               np.asarray(want.density_grid),
                               rtol=GRID_RTOL, atol=1e-6)
    grid = np.asarray(want.density_grid).reshape(-1)
    thresh = min(float(want.mean_density), 10.0)
    differ = got.bitfield.numpy() != np.asarray(want.bitfield)
    near = np.abs(grid - thresh) <= GRID_RTOL * abs(thresh) + 1e-6
    assert not (differ & ~near).any()
    assert 0.0 < float(got.bitfield.float().mean()) < 1.0
    # the teacher's grid is not the one refreshed
    tea_before = tr.occ_tea.density_grid.clone()
    tr.evaluate(Empty(), use_teacher=True, refresh_occ=True)
    assert torch.equal(tr.occ_tea.density_grid, tea_before)
