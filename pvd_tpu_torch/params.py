"""Weights and state carried over from the JAX package.

The JAX package keeps a field as a pytree of arrays; these functions take
it with numpy (or any array-protocol) leaves, so no JAX is needed here:
  * hash field: {"encoder": [T, 2], "sigma_net": [{"w": [in, out]}, ...],
    "color_net": [...]}; keys starting with "_" (the TPU's packed and baked
    gather tables) are ignored;
  * VM field: {"sigma_mat": 3 x [res[m1], res[m0], Rs], "sigma_vec":
    3 x [res[v], Rs], "color_mat", "color_vec" likewise with Rc,
    "basis_mat": {"w": [3 * Rc, geo]}, "color_net": [...]};
  * occupancy state: density_grid, bitfield, mean_density, iter_density,
    aabb_train, aabb_infer (the TPU probe masks are not carried).
"""

from __future__ import annotations

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.models.vm_field import VMField
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


def _val(p, grad: bool) -> np.ndarray:
    """A parameter's value, or its `.grad` when `grad` (zeros where None),
    as numpy."""
    t = p if not grad else (p.grad if p.grad is not None
                            else torch.zeros_like(p))
    return t.detach().cpu().numpy()


def hash_tree_from_field(field: HashField, grad: bool = False) -> dict:
    """The JAX package's hash pytree (numpy leaves) of a HashField's
    parameters, or of their `.grad` when `grad` (zeros where None)."""
    return {
        "encoder": _val(field.encoder, grad),
        "sigma_net": [{"w": _val(lin.weight, grad).T.copy()}
                      for lin in field.sigma_net],
        "color_net": [{"w": _val(lin.weight, grad).T.copy()}
                      for lin in field.color_net],
    }


def _leaf(x, want, name: str) -> np.ndarray:
    a = np.asarray(x, np.float32)
    if a.shape != tuple(want):
        raise ValueError(f"{name} has shape {a.shape}, expected {tuple(want)}")
    return a


def vm_field_from_jax(tree, spec: ModelSpec, device="cuda") -> VMField:
    """VMField holding the JAX params `tree` (see module docstring); the
    sigma and color factors are concatenated per branch."""
    device = resolve_device(device)
    field = VMField(spec, device=device)
    Rs = spec.vm_sigma_rank
    with torch.no_grad():
        for i in range(3):
            for tables, key in ((field.planes, "mat"), (field.lines, "vec")):
                t = tables[i]
                sig = _leaf(tree[f"sigma_{key}"][i], (*t.shape[:-1], Rs),
                            f"sigma_{key}[{i}]")
                col = _leaf(tree[f"color_{key}"][i],
                            (*t.shape[:-1], t.shape[-1] - Rs),
                            f"color_{key}[{i}]")
                t.copy_(torch.from_numpy(np.concatenate([sig, col], -1)))
        basis = tree["basis_mat"]
        if "b" in basis:
            raise ValueError("basis_mat has a bias; the VM field has none")
        field.basis_mat.copy_(torch.from_numpy(
            _leaf(basis["w"], field.basis_mat.shape, "basis_mat.w").copy()))
        _load_mlp(field.color_net, tree["color_net"], "color_net")
    return field


def vm_tree_from_field(field: VMField, grad: bool = False) -> dict:
    """The JAX package's VM pytree (numpy leaves) of a VMField's
    parameters, or of their `.grad` when `grad` (zeros where None)."""
    Rs = field.spec.vm_sigma_rank

    def val(p):
        return _val(p, grad)

    planes = [val(p) for p in field.planes]
    lines = [val(v) for v in field.lines]
    return {
        "sigma_mat": [p[..., :Rs].copy() for p in planes],
        "sigma_vec": [v[..., :Rs].copy() for v in lines],
        "color_mat": [p[..., Rs:].copy() for p in planes],
        "color_vec": [v[..., Rs:].copy() for v in lines],
        "basis_mat": {"w": val(field.basis_mat).copy()},
        "color_net": [{"w": val(lin.weight).T.copy()}
                      for lin in field.color_net],
    }


def occupancy_from_jax(state, device="cuda") -> OccupancyState:
    """OccupancyState from the JAX package's (attributes as arrays)."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return OccupancyState(
        density_grid=t(state.density_grid, torch.float32),
        bitfield=t(state.bitfield, torch.bool),
        mean_density=t(state.mean_density, torch.float32),
        iter_density=int(np.asarray(state.iter_density)),
        aabb_train=t(state.aabb_train, torch.float32),
        aabb_infer=t(state.aabb_infer, torch.float32),
    )
