"""Import the reference's PyTorch checkpoints (.pth) (port of
pvd_tpu/engine/import_torch.py).

Maps the reference NeRFNetwork state_dict (distill_mutual/network.py)
onto the JAX package's parameter pytree, with the same layout changes:
  * Linear weights [out, in] -> [in, out];
  * VM planes [1, R, H, W] -> [H, W, R]; lines [1, R, L, 1] -> [L, R];
  * the plenoxel volume [1, C, D, H, W] -> [D, H, W, C];
  * density_grid [CAS, H^3] in Morton order -> row-major [CAS, H, H, H].
The tree becomes the port's field through `params.field_from_tree`, and
the grid its `OccupancyState`, which `make_eval_renderer` serves as it
is.

The checkpoint's layout is the reference Trainer's save_checkpoint
(distill_mutual/utils.py:1405-1475): {epoch, global_step, stats,
model=state_dict, mean_count, mean_density[, resolution]}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.params import field_from_tree, spec_from_tree
from pvd_tpu_torch.render.occupancy import OccupancyState, from_morton_order


def _t(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _mlp_from_sd(sd: Dict, prefix: str, n_layers: int) -> list:
    layers = []
    for i in range(n_layers):
        layer = {"w": _t(sd[f"{prefix}.{i}.weight"]).T}
        if f"{prefix}.{i}.bias" in sd:
            layer["b"] = _t(sd[f"{prefix}.{i}.bias"])
        layers.append(layer)
    return layers


def params_from_state_dict(sd: Dict, spec: ModelSpec) -> dict:
    """A reference state_dict (numpy or tensor values) -> the JAX
    package's pytree for `spec.model_type`, numpy leaves
    (import_torch.py:40-71)."""
    params = {}
    mt = spec.model_type
    if mt in ("hash", "mlp"):
        params["sigma_net"] = _mlp_from_sd(sd, "sigma_net", spec.num_layers)
        params["color_net"] = _mlp_from_sd(sd, "color_net",
                                           spec.num_layers_color)
    if mt == "hash":
        params["encoder"] = _t(sd["encoder.embeddings"])
    elif mt == "mlp":
        params["nerf_mlp"] = _mlp_from_sd(sd, "nerf_mlp", spec.nerf_layer_num)
    elif mt == "vm":
        for prefix in ("sigma", "color"):
            params[f"{prefix}_mat"] = [
                _t(sd[f"{prefix}_mat.{i}"])[0].transpose(1, 2, 0)
                for i in range(3)]
            params[f"{prefix}_vec"] = [
                _t(sd[f"{prefix}_vec.{i}"])[0, :, :, 0].T for i in range(3)]
        params["basis_mat"] = {"w": _t(sd["basis_mat.weight"]).T}
        params["color_net"] = _mlp_from_sd(sd, "color_net",
                                           spec.num_layers_color)
    elif mt == "tensors":
        params["volume"] = _t(sd["tensor_volume.0"])[0].transpose(1, 2, 3, 0)
    if "bg_net.0.weight" in sd:
        params["bg"] = {"encoder": _t(sd["encoder_bg.embeddings"]),
                        "net": _mlp_from_sd(sd, "bg_net", spec.num_layers_bg)}
    return params


def occupancy_from_state_dict(sd: Dict, rspec: RenderSpec,
                              mean_density: float = 0.0,
                              device="cuda") -> OccupancyState:
    """The reference's Morton-ordered density grid as the port's state
    (import_torch.py:74-97): row-major grid, bitfield = grid >
    min(mean_density, density_thresh), iter_density 16, and the
    checkpoint's aabbs (the cube of `rspec.bound` where it has none).
    The JAX package also builds its TPU march masks here; the port's
    state has none (`engine/checkpoint.load_checkpoint` builds no more)."""
    device = resolve_device(device)
    H, C = rspec.grid_size, rspec.cascades
    grid_m = torch.as_tensor(_t(sd["density_grid"]), device=device)
    grid = from_morton_order(grid_m.reshape(C, H ** 3), H)
    thresh = min(float(mean_density), rspec.density_thresh)
    b = rspec.bound

    def aabb(key):
        return torch.as_tensor(_t(sd.get(key, [-b, -b, -b, b, b, b])),
                               device=device)

    return OccupancyState(
        density_grid=grid,
        bitfield=(grid > thresh).reshape(-1),
        mean_density=torch.tensor(float(mean_density), dtype=torch.float32,
                                  device=device),
        iter_density=16,
        aabb_train=aabb("aabb_train"),
        aabb_infer=aabb("aabb_infer"))


def load_torch_reference(path: str, spec: ModelSpec, rspec: RenderSpec,
                         device="cuda"):
    """Load a reference .pth -> (field, occupancy state, meta)
    (import_torch.py:100-117).  A VM or plenoxel field takes its table
    shapes from the state_dict (`params.spec_from_tree`).  `torch.load`
    unpickles the whole payload (weights_only=False, as the JAX package
    reads it), so load only files you trust."""
    device = resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("model", payload)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    tree = params_from_state_dict(sd, spec)
    field = field_from_tree(tree, spec_from_tree(tree, spec), device)
    occ = occupancy_from_state_dict(
        sd, rspec, mean_density=float(payload.get("mean_density", 0.0)),
        device=device)
    meta = {"step": int(payload.get("global_step", 0)),
            "mean_count": int(payload.get("mean_count", 0)),
            "resolution": payload.get("resolution")}
    return field, occ, meta
