"""Density-field mesh extraction (marching tetrahedra) and OBJ export
(port of pvd_tpu/utils/mesh.py).

The reference's extract_fields / extract_geometry
(distill_mutual/utils.py:442-488) sweep the density on a grid and run
PyMCubes' marching cubes.  The JAX package replaces marching cubes by
marching tetrahedra: every grid cube splits into 6 tetrahedra, and each
tetrahedron gives 0-2 triangles whose vertices interpolate linearly along
the edges that cross the threshold.  Here the sweep and the surface run
in torch on the density's device: the sweep through `query_fn` (for a
field, `density_query`, which reaches `models/api.field_density` and so
the hash encode kernels on the card), the surface with whole-grid tensor
ops.  Vertices and triangles come out in the JAX package's order
(tetrahedron, then inside-mask case, then the case's triangles, each over
the crossing cubes in grid order) with its float32 arithmetic, so the
mesh equals the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import field_density

# 6-tetrahedra decomposition of the unit cube (corner ids, bit order x,y,z)
_TETS = ((0, 5, 1, 3), (0, 5, 3, 7), (0, 5, 7, 4), (0, 7, 3, 2),
         (0, 7, 2, 6), (0, 7, 6, 4))
_CORNERS = tuple((k & 1, (k >> 1) & 1, (k >> 2) & 1) for k in range(8))


def density_query(field, spec, aabb) -> Callable:
    """fn(points [M, 3] tensor) -> densities [M], the field's density
    (`field_density`) without gradient, on the field's device."""
    def query(pts):
        with torch.no_grad():
            return field_density(field, spec, pts, aabb)
    return query


def _axis(bound_min, bound_max, resolution: int, k: int) -> np.ndarray:
    return np.linspace(bound_min[k], bound_max[k], resolution,
                       dtype=np.float32)


def extract_fields(bound_min, bound_max, resolution: int, query_fn: Callable,
                   chunk: int = 1 << 21, device="cuda") -> torch.Tensor:
    """Density sweep over the grid of the box -> [R, R, R] float32 on
    `device` (utils.py:442-473), at the JAX package's grid points (numpy
    float32 linspaces per axis, x slowest).  query_fn takes float32
    points [M, 3] on `device`, at most `chunk` a call, and returns their
    densities [M]."""
    R = resolution
    device = resolve_device(device)
    xs, ys, zs = (torch.from_numpy(_axis(bound_min, bound_max, R, k))
                  .to(device) for k in range(3))
    u = torch.empty(R ** 3, dtype=torch.float32, device=device)
    for head in range(0, R ** 3, chunk):
        idx = torch.arange(head, min(head + chunk, R ** 3), device=device)
        pts = torch.stack([xs[idx // (R * R)], ys[(idx // R) % R],
                           zs[idx % R]], dim=-1)
        u[head:head + idx.shape[0]] = query_fn(pts).reshape(-1).float()
    return u.reshape(R, R, R)


def _tet_case_triangles(pattern: int) -> list:
    """Edge recipes (pairs of tet-corner ids) for one inside-bitmask case:
    a list of triangles, each 3 (a, b) edges whose crossings are its
    vertices (mesh.py:53-76)."""
    ins = [i for i in range(4) if (pattern >> i) & 1]
    outs = [i for i in range(4) if not (pattern >> i) & 1]
    if len(ins) in (0, 4):
        return []
    if len(ins) == 1:
        a = ins[0]
        return [[(a, outs[0]), (a, outs[1]), (a, outs[2])]]
    if len(ins) == 3:
        a = outs[0]
        return [[(a, ins[0]), (a, ins[1]), (a, ins[2])]]
    i0, i1 = ins
    o0, o1 = outs
    # quad (i0,o0)-(i0,o1)-(i1,o1)-(i1,o0) -> two triangles
    return [[(i0, o0), (i0, o1), (i1, o1)], [(i0, o0), (i1, o1), (i1, o0)]]


def marching_tetrahedra(u, threshold: float) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Iso-surface of a scalar grid u [R, R, R] (tensor or numpy) at
    `threshold` (mesh.py:79-131): (vertices [V, 3] float32 in grid
    coordinates, triangles [F, 3] int32), on u's device, each triangle
    with its own three vertices."""
    u = torch.as_tensor(u, dtype=torch.float32)
    R = u.shape[0]
    dev = u.device
    n = R - 1
    corner_vals = [u[x:x + n, y:y + n, z:z + n].reshape(-1)
                   for x, y, z in _CORNERS]
    corner_off = torch.tensor(_CORNERS, device=dev)
    thr = torch.tensor(threshold, dtype=torch.float32).item()
    verts_out, tris_out = [], []
    v_count = 0
    for tet in _TETS:
        pattern = sum((corner_vals[c] > thr).to(torch.uint8) << i
                      for i, c in enumerate(tet))
        for case in range(1, 15):
            sel = torch.nonzero(pattern == case).reshape(-1)
            m = sel.shape[0]
            if m == 0:
                continue
            sv = torch.stack([corner_vals[c][sel] for c in tet], dim=1)
            cube = torch.stack([sel // (n * n), (sel // n) % n, sel % n],
                               dim=-1)
            sp = (cube[:, None, :]
                  + corner_off[list(tet)][None]).to(torch.float32)

            def crossing(a: int, b: int):
                va, vb = sv[:, a], sv[:, b]
                t = (thr - va) / torch.where(vb == va, 1e-9, vb - va)
                return sp[:, a] + t[:, None] * (sp[:, b] - sp[:, a])

            for tri in _tet_case_triangles(case):
                verts_out.append(torch.cat([crossing(a, b) for a, b in tri]))
                tris_out.append(v_count + torch.arange(
                    3 * m, device=dev).reshape(3, m).T)
                v_count += 3 * m
    if not verts_out:
        return (torch.zeros(0, 3, device=dev),
                torch.zeros(0, 3, dtype=torch.int32, device=dev))
    return (torch.cat(verts_out),
            torch.cat(tris_out).to(torch.int32))


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn: Callable, device="cuda",
                     chunk: int = 1 << 21) -> Tuple[np.ndarray, np.ndarray]:
    """Density sweep + iso-surface, vertices in world coordinates
    (utils.py:476-488): (vertices [V, 3] float32, triangles [F, 3] int32)
    as numpy arrays."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn, chunk,
                       device)
    verts, tris = marching_tetrahedra(u, threshold)
    bmin = torch.from_numpy(np.asarray(bound_min, np.float32)).to(u.device)
    bmax = torch.from_numpy(np.asarray(bound_max, np.float32)).to(u.device)
    verts = verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]
    return verts.cpu().numpy(), tris.cpu().numpy()


def save_obj(path: str, verts, tris):
    """Write a Wavefront OBJ: `v x y z` lines (6 decimals), then `f i j k`
    lines, 1-based (mesh.py:146-151)."""
    verts = np.asarray(verts, np.float32).tolist()
    tris = (np.asarray(tris, np.int64) + 1).tolist()
    with open(path, "w") as f:
        f.write("".join("v %.6f %.6f %.6f\n" % tuple(v) for v in verts))
        f.write("".join("f %d %d %d\n" % tuple(t) for t in tris))
