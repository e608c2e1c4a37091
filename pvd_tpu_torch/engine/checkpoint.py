"""Checkpoints (port of pvd_tpu/engine/checkpoint.py:31-154).

The JAX package's native format, unchanged: a pickled dict of numpy
pytrees and Python scalars

  {step, params, ema_params, occ{density_grid, bitfield, bitfield_dilated,
   mean_density, iter_density, aabb_train, aabb_infer}, stats, config_json}

so a `.ckpt` written by either package loads in the other, and reading one
needs neither JAX nor a GPU.  `params` is the JAX package's pytree
(`params.hash_tree_from_field` / `vm_tree_from_field`); keys starting with
"_" (derived gather tables) are never written.  The port's occupancy state
keeps no dilated bitfield, so `save_checkpoint` computes it for the file
and `load_checkpoint` ignores it.  Step checkpoints keep the last
`max_keep`; a fixed `filename` (e.g. "{name}_best.ckpt") is exempt.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch

from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.render.occupancy import OccupancyState, dilate_bitfield


def _to_numpy(tree):
    """numpy leaves; '_'-prefixed dict keys dropped (checkpoint.py:31-37)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()
                if not k.startswith("_")}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path_dir: str, name: str, step: int, params,
                    occ: OccupancyState, ema_params=None,
                    stats: Optional[dict] = None,
                    config_json: Optional[str] = None, max_keep: int = 2,
                    filename: Optional[str] = None) -> str:
    """Write a checkpoint; returns its path.  `params` (and `ema_params`)
    are pytrees in the JAX package's layout, with numpy or tensor leaves."""
    os.makedirs(path_dir, exist_ok=True)
    H = occ.density_grid.shape[1]
    payload = {
        "step": int(step),
        "params": _to_numpy(params),
        "ema_params": None if ema_params is None else _to_numpy(ema_params),
        "occ": {
            "density_grid": _to_numpy(occ.density_grid),
            "bitfield": _to_numpy(occ.bitfield),
            "bitfield_dilated": _to_numpy(dilate_bitfield(occ.bitfield, H)),
            "mean_density": float(occ.mean_density),
            "iter_density": int(occ.iter_density),
            "aabb_train": _to_numpy(occ.aabb_train),
            "aabb_infer": _to_numpy(occ.aabb_infer),
        },
        "stats": stats or {},
        "config_json": config_json,
    }
    path = os.path.join(path_dir, filename or f"{name}_step{step:08d}.ckpt")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    if filename is None:
        old = sorted(glob.glob(os.path.join(path_dir, f"{name}_step*.ckpt")))
        for p in old[:-max_keep]:
            os.remove(p)
    return path


def save_best(path_dir: str, name: str, payload_path: str) -> str:
    """Copy a checkpoint to `{name}_best.ckpt` in path_dir, the
    best-metric snapshot (checkpoint.py:82-88); returns its path."""
    best = os.path.join(path_dir, f"{name}_best.ckpt")
    shutil.copyfile(payload_path, best)
    return best


def latest_checkpoint(path_dir: str, name: str) -> Optional[str]:
    cands = sorted(glob.glob(os.path.join(path_dir, f"{name}_step*.ckpt")))
    return cands[-1] if cands else None


def load_checkpoint(path: str, device="cuda") -> dict:
    """Read a checkpoint: {step, params, ema_params (numpy pytrees or
    None), occ (an OccupancyState on `device`), stats, config_json}."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    occ_d = payload["occ"]

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    occ = OccupancyState(
        density_grid=t(occ_d["density_grid"], torch.float32),
        bitfield=t(occ_d["bitfield"], torch.bool),
        mean_density=t(occ_d["mean_density"], torch.float32),
        iter_density=int(occ_d["iter_density"]),
        aabb_train=t(occ_d["aabb_train"], torch.float32),
        aabb_infer=t(occ_d["aabb_infer"], torch.float32),
    )
    return {
        "step": int(payload["step"]),
        "params": payload["params"],
        "ema_params": payload.get("ema_params"),
        "occ": occ,
        "stats": payload.get("stats", {}),
        "config_json": payload.get("config_json"),
    }


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _map_with_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def warm_start_student(student_params, teacher_params):
    """Teacher -> student warm start (checkpoint.py:137-154): every
    student leaf whose path and shape match a teacher leaf takes the
    teacher's value.  For hash -> VM that is the color_net head."""
    teacher = dict(_leaves_with_paths(teacher_params))

    def maybe_copy(path, leaf):
        src = teacher.get(path)
        if src is not None and np.shape(src) == np.shape(leaf):
            return src
        return leaf

    return _map_with_paths(maybe_copy, student_params)
