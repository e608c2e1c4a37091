"""pvd_tpu_torch stands alone: no JAX, GPU by default, no hidden fallback."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pvd_tpu_torch.config import ModelSpec, PVDConfig, RenderSpec
from pvd_tpu_torch.engine.train_steps import (make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step)
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.models.vm_field import VMField
from pvd_tpu_torch.ops.composite import (composite_rays,
                                         composite_rays_bwd,
                                         composite_rays_compact,
                                         composite_rays_compact_bwd)
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, hash_encode,
                                        hash_encode_bwd)
from pvd_tpu_torch.ops.vm_sample import (vm_sample, vm_sample_bwd,
                                         vm_sample_fwd)
from pvd_tpu_torch.params import vm_field_from_jax, vm_tree_from_field
from pvd_tpu_torch.render.occupancy import init_occupancy_state
from pvd_tpu_torch.render.renderer import march_rays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pvd_tpu"}


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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
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


SMALL = ModelSpec(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128)
VM = ModelSpec(model_type="vm", vm_sigma_rank=2, vm_color_rank=3,
               vm_resolution=(4, 5, 6))
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
], ids=["HashField", "make_occ_update", "make_eval_renderer",
        "init_occupancy_state", "VMField", "vm_field_from_jax",
        "make_distill_step", "make_teacher_step", "Trainer"])
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
