"""Weights and state carried over from the JAX package.

The JAX package keeps a field as a pytree of arrays; these functions take
it with numpy (or any array-protocol) leaves, so no JAX is needed here:
  * hash field: {"encoder": [T, 2], "sigma_net": [{"w": [in, out]}, ...],
    "color_net": [...]}, and "encoder_cell": [Tc, 16] in cell mode; keys
    starting with "_" (the TPU's packed and baked gather tables) are
    ignored;
  * MLP field: {"nerf_mlp": [{"w": [in, out], "b": [out]}, ...],
    "sigma_net": [...], "color_net": [...]};
  * plenoxel field: {"volume": [D, H, W, 1 + 3 deg^2]};
  * VM field: {"sigma_mat": 3 x [res[m1], res[m0], Rs], "sigma_vec":
    3 x [res[v], Rs], "color_mat", "color_vec" likewise with Rc,
    "basis_mat": {"w": [3 * Rc, geo]}, "color_net": [...]};
  * either field with a background model (bg_radius > 0) also holds
    "bg": {"encoder": [697776, 2], "net": [{"w": [in, out]}, ...]};
  * occupancy state: density_grid, bitfield, mean_density, iter_density,
    aabb_train, aabb_infer (the TPU probe masks are not carried).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.models.mlp_field import MLPField
from pvd_tpu_torch.models.tensors_field import TensorsField
from pvd_tpu_torch.models.vm_field import VMField
from pvd_tpu_torch.render.occupancy import OccupancyState

FIELDS = {"hash": HashField, "mlp": MLPField, "vm": VMField,
          "tensors": TensorsField}


def new_field(spec: ModelSpec, device="cuda",
              generator: torch.Generator | None = None):
    """A freshly initialized field of `spec.model_type` (api.py:42-49)."""
    return FIELDS[spec.model_type](spec, device=device, generator=generator)


def _load_mlp(layers, tree_layers, name: str):
    """Copy JAX Linear layers ({"w": [in, out]} and, where the field's
    layer has a bias, "b": [out]) into `layers`."""
    if len(layers) != len(tree_layers):
        raise ValueError(f"{name}: {len(tree_layers)} layers, field has "
                         f"{len(layers)}")
    for i, (lin, p) in enumerate(zip(layers, tree_layers)):
        w = np.asarray(p["w"], np.float32)
        if w.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"{name}[{i}].w has shape {w.shape}, expected "
                             f"{(lin.in_features, lin.out_features)}")
        if ("b" in p) != (lin.bias is not None):
            raise ValueError(f"{name}[{i}]: a bias in the tree but not in "
                             "the field, or the other way round")
        lin.weight.data.copy_(torch.from_numpy(w.T.copy()))
        if lin.bias is not None:
            lin.bias.data.copy_(torch.from_numpy(
                _leaf(p["b"], lin.bias.shape, f"{name}[{i}].b")))


def _mlp_tree(layers, grad: bool) -> list:
    """JAX Linear layers of `layers` (their `.grad` when `grad`)."""
    out = []
    for lin in layers:
        p = {"w": _val(lin.weight, grad).T.copy()}
        if lin.bias is not None:
            p["b"] = _val(lin.bias, grad)
        out.append(p)
    return out


def _load_bg(field, tree):
    """Copy the tree's "bg" subtree into the field's background model; each
    must have one when the other does."""
    if (field.bg is None) != ("bg" not in tree):
        raise ValueError("bg is in the tree but not in the spec, or the other"
                         " way round (bg_radius)")
    if field.bg is None:
        return
    field.bg.encoder.copy_(torch.from_numpy(_leaf(
        tree["bg"]["encoder"], field.bg.encoder.shape, "bg.encoder")))
    _load_mlp(field.bg.net, tree["bg"]["net"], "bg.net")


def _bg_tree(field, grad: bool):
    return {"encoder": _val(field.bg.encoder, grad),
            "net": _mlp_tree(field.bg.net, grad)}


def hash_field_from_jax(tree, spec: ModelSpec, device="cuda") -> HashField:
    """HashField holding the JAX params `tree` (see module docstring)."""
    device = resolve_device(device)
    field = HashField(spec, device=device)
    table = np.asarray(tree["encoder"], np.float32)
    want = (field.grid.table_size, field.grid.level_dim)
    if table.shape != want:
        raise ValueError(f"encoder has shape {table.shape}; the spec's "
                         f"HashGridSpec.offsets give {want}")
    if (field.encoder_cell is None) != ("encoder_cell" not in tree):
        raise ValueError("encoder_cell is in the tree but not in the spec, "
                         "or the other way round (hash_cell_levels)")
    with torch.no_grad():
        field.encoder.copy_(torch.from_numpy(table))
        if field.encoder_cell is not None:
            field.encoder_cell.copy_(torch.from_numpy(_leaf(
                tree["encoder_cell"], field.encoder_cell.shape,
                "encoder_cell")))
        _load_mlp(field.sigma_net, tree["sigma_net"], "sigma_net")
        _load_mlp(field.color_net, tree["color_net"], "color_net")
        _load_bg(field, tree)
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
    tree = {
        "encoder": _val(field.encoder, grad),
        "sigma_net": _mlp_tree(field.sigma_net, grad),
        "color_net": _mlp_tree(field.color_net, grad),
    }
    if field.encoder_cell is not None:
        tree["encoder_cell"] = _val(field.encoder_cell, grad)
    if field.bg is not None:
        tree["bg"] = _bg_tree(field, grad)
    return tree


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
        _load_bg(field, tree)
    return field


def vm_tree_from_field(field: VMField, grad: bool = False) -> dict:
    """The JAX package's VM pytree (numpy leaves) of a VMField's
    parameters, or of their `.grad` when `grad` (zeros where None)."""
    Rs = field.spec.vm_sigma_rank

    def val(p):
        return _val(p, grad)

    planes = [val(p) for p in field.planes]
    lines = [val(v) for v in field.lines]
    tree = {
        "sigma_mat": [p[..., :Rs].copy() for p in planes],
        "sigma_vec": [v[..., :Rs].copy() for v in lines],
        "color_mat": [p[..., Rs:].copy() for p in planes],
        "color_vec": [v[..., Rs:].copy() for v in lines],
        "basis_mat": {"w": val(field.basis_mat).copy()},
        "color_net": _mlp_tree(field.color_net, grad),
    }
    if field.bg is not None:
        tree["bg"] = _bg_tree(field, grad)
    return tree


def mlp_field_from_jax(tree, spec: ModelSpec, device="cuda") -> MLPField:
    """MLPField holding the JAX params `tree` (see module docstring)."""
    field = MLPField(spec, device=resolve_device(device))
    with torch.no_grad():
        _load_mlp(field.nerf_mlp, tree["nerf_mlp"], "nerf_mlp")
        _load_mlp(field.sigma_net, tree["sigma_net"], "sigma_net")
        _load_mlp(field.color_net, tree["color_net"], "color_net")
        _load_bg(field, tree)
    return field


def mlp_tree_from_field(field: MLPField, grad: bool = False) -> dict:
    """The JAX package's MLP pytree (numpy leaves) of an MLPField's
    parameters, or of their `.grad` when `grad` (zeros where None)."""
    tree = {"nerf_mlp": _mlp_tree(field.nerf_mlp, grad),
            "sigma_net": _mlp_tree(field.sigma_net, grad),
            "color_net": _mlp_tree(field.color_net, grad)}
    if field.bg is not None:
        tree["bg"] = _bg_tree(field, grad)
    return tree


def tensors_field_from_jax(tree, spec: ModelSpec,
                           device="cuda") -> TensorsField:
    """TensorsField holding the JAX params `tree` (see module
    docstring)."""
    field = TensorsField(spec, device=resolve_device(device))
    with torch.no_grad():
        field.volume.copy_(torch.from_numpy(_leaf(
            tree["volume"], field.volume.shape, "volume")))
        _load_bg(field, tree)
    return field


def tensors_tree_from_field(field: TensorsField, grad: bool = False) -> dict:
    """The JAX package's plenoxel pytree (numpy leaves) of a TensorsField's
    volume, or of its `.grad` when `grad` (zeros where None)."""
    tree = {"volume": _val(field.volume, grad)}
    if field.bg is not None:
        tree["bg"] = _bg_tree(field, grad)
    return tree


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


_FROM_JAX = {"hash": hash_field_from_jax, "mlp": mlp_field_from_jax,
             "vm": vm_field_from_jax, "tensors": tensors_field_from_jax}
_TO_JAX = {HashField: hash_tree_from_field, MLPField: mlp_tree_from_field,
           VMField: vm_tree_from_field, TensorsField: tensors_tree_from_field}


def spec_from_tree(tree, spec: ModelSpec) -> ModelSpec:
    """`spec` with the table shapes of `tree`: a VM field's per-axis
    resolution read from its planes and lines (trainer.py:240-245), a
    plenoxel field's from its volume.  A resized field's checkpoint holds
    shapes its run's config does not name."""
    if spec.model_type == "vm":
        m0 = np.shape(tree["sigma_mat"][0])
        v0 = np.shape(tree["sigma_vec"][0])
        return dataclasses.replace(spec, vm_resolution=(m0[1], m0[0], v0[0]))
    if spec.model_type == "tensors":
        return dataclasses.replace(
            spec, plenoxel_res=tuple(np.shape(tree["volume"])[:3]))
    return spec


def field_from_tree(tree, spec: ModelSpec, device="cuda"):
    """The field of `spec.model_type` holding the JAX pytree `tree`."""
    return _FROM_JAX[spec.model_type](tree, spec, device)


def tree_from_field(field, grad: bool = False) -> dict:
    """The JAX pytree (numpy leaves) of a field, or of its gradients when
    `grad`."""
    return _TO_JAX[type(field)](field, grad)
