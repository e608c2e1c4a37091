"""pvd_tpu_torch stands alone: no JAX, no cv2 or PIL, GPU by default, no
hidden fallback."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pvd_tpu_torch.cli import distill as distill_cli
from pvd_tpu_torch.cli import train_teacher as teacher_cli
from pvd_tpu_torch.config import ModelSpec, PVDConfig, RenderSpec
from pvd_tpu_torch.engine.checkpoint import load_checkpoint
from pvd_tpu_torch.engine.train_steps import (make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step,
                                              make_teacher_step_host)
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.models.mlp_field import MLPField
from pvd_tpu_torch.models.tensors_field import TensorsField
from pvd_tpu_torch.models.vm_field import VMField
from pvd_tpu_torch.ops.composite import (composite_rays,
                                         composite_rays_bwd,
                                         composite_rays_compact,
                                         composite_rays_compact_bwd)
from pvd_tpu_torch.models.api import bg_grid_spec
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, build_baked_dense,
                                        hash_encode, hash_encode_baked_fwd,
                                        hash_encode_bwd,
                                        hash_encode_cell_bwd,
                                        hash_encode_cell_fwd, hash_encode_fwd)
from pvd_tpu_torch.ops.vm_sample import (vm_sample, vm_sample_bwd,
                                         vm_sample_fwd)
from pvd_tpu_torch.params import (mlp_field_from_jax, mlp_tree_from_field,
                                  tensors_field_from_jax,
                                  tensors_tree_from_field, vm_field_from_jax,
                                  vm_tree_from_field)
from pvd_tpu_torch.render.occupancy import init_occupancy_state
from pvd_tpu_torch.render.renderer import march_rays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pvd_tpu", "cv2", "PIL"}
# imported only inside the function that needs it (the video writer)
LOCAL_ONLY = {"imageio"}


def _port_files():
    files = sorted((ROOT / "pvd_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_new_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"pvd_tpu_torch/models/vm_field.py",
            "pvd_tpu_torch/ops/vm_sample.py", "pvd_tpu_torch/engine/optim.py",
            "pvd_tpu_torch/engine/train_steps.py"} <= names
    # the teacher slice's modules
    assert {f"pvd_tpu_torch/{m}.py" for m in (
        "ops/hashgrid", "models/hash_field", "params", "ops/composite",
        "render/occupancy", "engine/train_steps", "utils/misc",
        "utils/metrics", "engine/autotune", "data/poses", "data/synth",
        "config", "engine/trainer")} <= names
    # the quality-recipe slice's
    assert "pvd_tpu_torch/engine/checkpoint.py" in names
    # the large-scene slice's (the background model lives in models/api)
    assert {"pvd_tpu_torch/ops/aabb.py", "pvd_tpu_torch/models/api.py",
            "pvd_tpu_torch/render/renderer.py"} <= names
    # the distillation CLI's
    assert {f"pvd_tpu_torch/{m}.py" for m in (
        "cli/common", "cli/distill", "data/png", "data/provider")} <= names
    # the teacher CLI's and the MLP and plenoxel fields'
    assert {f"pvd_tpu_torch/{m}.py" for m in (
        "cli/train_teacher", "data/raybatch", "ops/freq", "ops/grid_sample",
        "models/mlp_field", "models/tensors_field")} <= names
    # data parallelism's
    assert {f"pvd_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "dp")} <= names


def test_native_batcher_source_is_the_ports_own():
    """The host batcher builds its own copy of the producer (csrc/), not the
    JAX package's native/ files."""
    from pvd_tpu_torch.data import raybatch

    assert raybatch.SOURCE == ROOT / "pvd_tpu_torch" / "csrc" / \
        "raybatch.cpp"
    assert raybatch.BUILD_DIR == ROOT / "build" / "raybatch"
    text = (ROOT / "pvd_tpu_torch" / "data" / "raybatch.py").read_text()
    assert "native/" not in text.replace("native/raybatch.cpp", "")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name} imports {name}"
            assert not (name.split(".")[0] in LOCAL_ONLY and id(node) in top), \
                f"{path.name} imports {name} at module level"


SMALL = ModelSpec(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128)
VM = ModelSpec(model_type="vm", vm_sigma_rank=2, vm_color_rank=3,
               vm_resolution=(4, 5, 6))
MLP = ModelSpec(model_type="mlp", nerf_layer_num=3, nerf_layer_wide=8,
                pe_multires=2, skip=0)
TENSORS = ModelSpec(model_type="tensors", plenoxel_res=(4, 5, 6))
RSPEC = RenderSpec(grid_size=32, max_steps=128, samples_per_ray=4)


def _vm_tree():
    return vm_tree_from_field(VMField(VM, "cpu"))


@pytest.mark.parametrize("entry", [
    lambda: HashField(SMALL),
    lambda: make_occ_update(SMALL, RSPEC),
    lambda: make_eval_renderer(SMALL, RSPEC),
    lambda: init_occupancy_state(RSPEC),
    lambda: VMField(VM),
    lambda: vm_field_from_jax(_vm_tree(), VM),
    lambda: make_distill_step(VM, SMALL, RSPEC, None, PVDConfig(),
                              (1, 1, 1, 1), 4, 4, stage=3),
    lambda: make_teacher_step(SMALL, RSPEC, None, PVDConfig(), (1, 1, 1, 1),
                              4, 4, image_channels=4),
    lambda: Trainer(PVDConfig()),
    lambda: Trainer(PVDConfig(model_type="vm"), mode="distill"),
    lambda: HashField(ModelSpec(hash_num_levels=6, hash_base_res=4,
                                hash_desired_res=64, hash_log2_size=9,
                                hash_cell_levels=2)),
    lambda: load_checkpoint("no_such_file.ckpt"),
    lambda: distill_cli.main(["no_such_scene", "--model_type", "vm",
                              "--test"]),
    lambda: MLPField(MLP),
    lambda: TensorsField(TENSORS),
    lambda: mlp_field_from_jax(mlp_tree_from_field(MLPField(MLP, "cpu")),
                               MLP),
    lambda: tensors_field_from_jax(
        tensors_tree_from_field(TensorsField(TENSORS, "cpu")), TENSORS),
    lambda: make_teacher_step_host(MLP, RSPEC, None, PVDConfig(),
                                   (1, 1, 1, 1), 4, 4, image_channels=4),
    lambda: Trainer(PVDConfig(model_type="tensors", preload=False)),
    lambda: Trainer(PVDConfig(model_type="mlp", teacher_type="tensors"),
                    mode="distill"),
    lambda: teacher_cli.main(["no_such_scene", "--model_type", "mlp",
                              "--test"]),
], ids=["HashField", "make_occ_update", "make_eval_renderer",
        "init_occupancy_state", "VMField", "vm_field_from_jax",
        "make_distill_step", "make_teacher_step", "Trainer",
        "Trainer-distill", "HashField-cell", "load_checkpoint",
        "distill-cli", "MLPField", "TensorsField", "mlp_field_from_jax",
        "tensors_field_from_jax", "make_teacher_step_host",
        "Trainer-host-batcher", "Trainer-tensors2mlp", "teacher-cli"])
def test_entry_points_need_a_gpu_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    before = (hash_encode.launches, march_rays.launches,
              composite_rays_compact.launches)
    gs = HashGridSpec(num_levels=2, log2_hashmap_size=12,
                      desired_resolution=32)
    enc = hash_encode(torch.zeros(gs.table_size, 2), torch.rand(5, 3), gs)
    assert enc.shape == (5, 4)
    o = torch.zeros(3, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    s = march_rays(torch.ones(32 ** 3, dtype=torch.bool), o - 2, d,
                   torch.full((3,), 1.0), torch.full((3,), 3.0), RSPEC)
    assert s.mask.any()
    ws, _, _, _ = composite_rays_compact(
        torch.ones(4), torch.rand(4, 3), torch.full((4,), 0.1),
        torch.ones(4), torch.tensor([0, 0, 1, 0]),
        torch.tensor([True, True, True, False]), 2)
    assert np.isfinite(ws.numpy()).all()
    assert (hash_encode.launches, march_rays.launches,
            composite_rays_compact.launches) == before


def test_training_wrappers_take_the_plain_path_on_cpu_without_counting():
    """K4, K5 and K6: the plain version (autograd for K6) on CPU tensors,
    and no count."""
    before = (vm_sample_fwd.launches, vm_sample_bwd.launches,
              composite_rays_compact.launches,
              composite_rays_compact_bwd.launches)
    field = VMField(VM, "cpu")
    xn = torch.rand(7, 3) * 2 - 1
    planes, lines = list(field.planes), list(field.lines)
    prod = vm_sample_fwd(planes, lines, xn)
    assert prod.shape == (3, 7, 5) and not prod.requires_grad
    g_planes, g_lines = vm_sample_bwd(planes, lines, xn, torch.ones(3, 7, 5))
    assert [g.shape for g in g_planes] == [p.shape for p in planes]
    assert [g.shape for g in g_lines] == [v.shape for v in lines]
    vm_sample(planes, lines, xn).sum().backward()
    assert all(p.grad is not None for p in planes)
    sig = torch.ones(4, requires_grad=True)
    ws, _, img, _ = composite_rays_compact(
        sig, torch.rand(4, 3), torch.full((4,), 0.1), torch.ones(4),
        torch.tensor([0, 0, 1, 0]), torch.tensor([True, True, True, False]),
        2)
    (ws.sum() + img.sum()).backward()
    assert sig.grad[:3].abs().sum() > 0 and sig.grad[3] == 0
    assert (vm_sample_fwd.launches, vm_sample_bwd.launches,
            composite_rays_compact.launches,
            composite_rays_compact_bwd.launches) == before


def test_wrappers_refuse_mixed_devices():
    gs = HashGridSpec(num_levels=2, log2_hashmap_size=12,
                      desired_resolution=32)
    with pytest.raises(ValueError):
        hash_encode(torch.zeros(gs.table_size, 2, device="meta"),
                    torch.rand(5, 3), gs)


def test_teacher_wrappers_take_the_plain_path_on_cpu_without_counting():
    """K7 (through the hash encode's autograd), K8 and K9 (through the
    padded composite's autograd): the plain versions on CPU tensors, and no
    count."""
    before = (hash_encode.launches, hash_encode_bwd.launches,
              composite_rays.launches, composite_rays_bwd.launches)
    gs = HashGridSpec(num_levels=2, log2_hashmap_size=12,
                      desired_resolution=32)
    table = torch.rand(gs.table_size, 2, requires_grad=True)
    hash_encode(table, torch.rand(5, 3), gs).sum().backward()
    assert table.grad.abs().sum() > 0
    g = hash_encode_bwd(torch.rand(5, 3), torch.ones(5, 4), gs)
    assert g.shape == (gs.table_size, 2)
    sig = torch.ones(2, 3, requires_grad=True)
    ws, _, img, w = composite_rays(
        sig, torch.rand(2, 3, 3), torch.full((2, 3), 0.1), torch.ones(2, 3),
        torch.tensor([[True, True, False], [True, False, False]]))
    (ws.sum() + img.sum()).backward()
    assert w.shape == (2, 3) and sig.grad[0, :2].abs().sum() > 0
    assert sig.grad[0, 2] == 0 and sig.grad[1, 1:].abs().sum() == 0
    assert (hash_encode.launches, hash_encode_bwd.launches,
            composite_rays.launches, composite_rays_bwd.launches) == before


def test_cell_wrappers_take_the_plain_path_on_cpu_without_counting():
    """K10 and K11 (through the hash encode's autograd, and called
    directly): the plain versions on CPU tensors, and no count."""
    before = (hash_encode_cell_fwd.launches, hash_encode_cell_bwd.launches)
    gs = HashGridSpec(num_levels=6, base_resolution=4, desired_resolution=64,
                      log2_hashmap_size=9, n_cell_levels=2)
    table = torch.rand(gs.table_size, 2)
    cell = torch.rand(gs.cell_table_size, 16, requires_grad=True)
    hash_encode(table, torch.rand(5, 3), gs, cell).sum().backward()
    assert cell.grad.abs().sum() > 0
    out = hash_encode_cell_fwd(cell.detach(), torch.rand(5, 3), gs,
                               torch.zeros(5, 12))
    assert out[:, 8:].abs().sum() > 0 and not out[:, :8].any()
    g = hash_encode_cell_bwd(torch.rand(5, 3), torch.ones(5, 12), gs)
    assert g.shape == (gs.cell_table_size, 16)
    assert (hash_encode_cell_fwd.launches,
            hash_encode_cell_bwd.launches) == before


def test_large_scene_wrappers_take_the_plain_path_on_cpu_without_counting():
    """K12 and K13 (the 2-D encode, directly and through the hash encode's
    autograd) and K14 (the geometric march): the plain versions on CPU
    tensors, and no count."""
    def counts():
        return (hash_encode.launches, hash_encode.launches_2d,
                hash_encode_bwd.launches, hash_encode_bwd.launches_2d,
                march_rays.launches, march_rays.launches_geom)

    before = counts()
    gs = bg_grid_spec()
    table = torch.rand(gs.table_size, 2, requires_grad=True)
    hash_encode(table, torch.rand(5, 2), gs).sum().backward()
    assert table.grad.abs().sum() > 0
    assert hash_encode_fwd(table.detach(), torch.rand(5, 2), gs).shape \
        == (5, 8)
    assert hash_encode_bwd(torch.rand(5, 2), torch.ones(5, 8), gs).shape \
        == (gs.table_size, 2)
    rs = RenderSpec(bound=2.0, grid_size=32, max_steps=128, dt_gamma=1 / 256)
    o = torch.zeros(3, 3) - torch.tensor([0.0, 0.0, 3.0])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    bits = torch.ones(2 * 32 ** 3, dtype=torch.bool)
    near, far = torch.full((3,), 1.0), torch.full((3,), 5.0)
    s = march_rays(bits, o, d, near, far, rs)
    assert s.mask.any() and (s.dt[s.mask] > rs.max_steps ** -1).all()
    assert counts() == before


def test_bake_wrappers_take_the_plain_path_on_cpu_without_counting():
    """K16 (the bake) and K15 (the baked encode, through `hash_encode` and
    a baked field): the plain versions on CPU tensors, and no count; K1
    does not count either."""
    def counts():
        return (build_baked_dense.launches, hash_encode_baked_fwd.launches,
                hash_encode.launches)

    before = counts()
    gs = HashGridSpec(num_levels=5, base_resolution=4, desired_resolution=32,
                      log2_hashmap_size=12)
    table = torch.rand(gs.table_size, 2)
    baked = build_baked_dense(table, gs)
    assert baked.shape == (gs.level_side(gs.dense_levels[-1]) ** 3,
                           2 * len(gs.dense_levels))
    with torch.no_grad():
        assert hash_encode(table, torch.rand(5, 3), gs,
                           baked=baked).shape == (5, 10)
    out = hash_encode_baked_fwd(baked, torch.rand(5, 3), gs,
                                torch.zeros(5, 10))
    dense = [2 * lv + c for lv in gs.dense_levels for c in (0, 1)]
    assert out[:, dense].abs().sum() > 0
    assert not out[:, [c for c in range(10) if c not in dense]].any()
    field = HashField(ModelSpec(hash_num_levels=5, hash_base_res=4,
                                hash_desired_res=32, hash_log2_size=12,
                                hash_bake_dense=True), "cpu").bake()
    with torch.no_grad():
        assert field.density(torch.rand(6, 3)).shape[0] == 6
    assert counts() == before


@pytest.mark.parametrize("where", ["alone", "repo_without_gpu"])
def test_chip_smoke_prints_no_result_without_the_package_or_a_gpu(
        where, tmp_path):
    """chip_smoke.py exits 1 and prints no {"ok": true} line when it stands
    in a directory without the package (the script alone) or finds no
    GPU; on the GPU, beside the package, it ends with that line and 0."""
    import shutil
    import subprocess
    import sys

    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 1, run.stderr[-2000:]
    assert '"ok"' not in run.stdout
