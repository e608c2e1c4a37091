"""Weights and state carried over from the JAX package.

The JAX package keeps a field as a pytree of arrays; these functions take
it with numpy (or any array-protocol) leaves, so no JAX is needed here:
  * hash field: {"encoder": [T, 2], "sigma_net": [{"w": [in, out]}, ...],
    "color_net": [...]}; keys starting with "_" (the TPU's packed and baked
    gather tables) are ignored;
  * occupancy state: density_grid, bitfield, mean_density, iter_density,
    aabb_train, aabb_infer (the TPU probe masks are not carried).
"""

from __future__ import annotations

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.render.occupancy import OccupancyState


def _load_mlp(layers, tree_layers, name: str):
    if len(layers) != len(tree_layers):
        raise ValueError(f"{name}: {len(tree_layers)} layers, field has "
                         f"{len(layers)}")
    for i, (lin, p) in enumerate(zip(layers, tree_layers)):
        w = np.asarray(p["w"], np.float32)
        if w.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"{name}[{i}].w has shape {w.shape}, expected "
                             f"{(lin.in_features, lin.out_features)}")
        if "b" in p:
            raise ValueError(f"{name}[{i}] has a bias; the heads have none")
        lin.weight.data.copy_(torch.from_numpy(w.T.copy()))


def hash_field_from_jax(tree, spec: ModelSpec, device="cuda") -> HashField:
    """HashField holding the JAX params `tree` (see module docstring)."""
    device = resolve_device(device)
    field = HashField(spec, device=device)
    table = np.asarray(tree["encoder"], np.float32)
    want = (field.grid.table_size, field.grid.level_dim)
    if table.shape != want:
        raise ValueError(f"encoder has shape {table.shape}; the spec's "
                         f"HashGridSpec.offsets give {want}")
    with torch.no_grad():
        field.encoder.copy_(torch.from_numpy(table))
        _load_mlp(field.sigma_net, tree["sigma_net"], "sigma_net")
        _load_mlp(field.color_net, tree["color_net"], "color_net")
    return field


def occupancy_from_jax(state, device="cuda") -> OccupancyState:
    """OccupancyState from the JAX package's (attributes as arrays)."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return OccupancyState(
        density_grid=t(state.density_grid, torch.float32),
        bitfield=t(state.bitfield, torch.bool),
        mean_density=t(state.mean_density, torch.float32),
        iter_density=int(np.asarray(state.iter_density)),
        aabb_train=t(state.aabb_train, torch.float32),
        aabb_infer=t(state.aabb_infer, torch.float32),
    )
