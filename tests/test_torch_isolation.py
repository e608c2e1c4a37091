"""pvd_tpu_torch stands alone: no JAX, GPU by default, no hidden fallback."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.engine.train_steps import (make_eval_renderer,
                                              make_occ_update)
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.ops.composite import composite_rays_compact
from pvd_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode
from pvd_tpu_torch.render.occupancy import init_occupancy_state
from pvd_tpu_torch.render.renderer import march_rays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pvd_tpu"}


def _port_files():
    files = sorted((ROOT / "pvd_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


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
RSPEC = RenderSpec(grid_size=32, max_steps=128, samples_per_ray=4)


@pytest.mark.parametrize("entry", [
    lambda: HashField(SMALL),
    lambda: make_occ_update(SMALL, RSPEC),
    lambda: make_eval_renderer(SMALL, RSPEC),
    lambda: init_occupancy_state(RSPEC),
], ids=["HashField", "make_occ_update", "make_eval_renderer",
        "init_occupancy_state"])
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


def test_wrappers_refuse_mixed_devices():
    gs = HashGridSpec(num_levels=2, log2_hashmap_size=12,
                      desired_resolution=32)
    with pytest.raises(ValueError):
        hash_encode(torch.zeros(gs.table_size, 2, device="meta"),
                    torch.rand(5, 3), gs)
