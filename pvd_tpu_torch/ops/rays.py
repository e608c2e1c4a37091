"""Camera rays and pose conventions (port of pvd_tpu/ops/rays.py).

Full-image rays, or rays at pixel ids drawn from an explicit
`torch.Generator`: uniformly (`random_pixels`, the draw of get_rays in
rays.py:63-67) or by importance from a 128 x 128 error map of the image
(`draw_error_map_pixels`, rays.py:67-81: a cell drawn with probability
proportional to max(weight, 1e-12), with replacement, then a uniform
jitter inside it; `error_map_pixels` maps cells and jitters to pixels).
`draw_error_map_inds_np` is the host flavor of that draw, numpy as in the
JAX package (rays.py:97-117), so the same `np.random.Generator` gives the
same pixels in both.  The norm and the rotation use `fma32` where XLA:CPU
contracts them (ops/fma.py), so the port's rays equal the JAX package's
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pvd_tpu_torch.ops.fma import fma32


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33) -> np.ndarray:
    """NeRF (blender) c2w -> NGP convention: axis cycle + y/z flip + t*scale."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def pixel_dirs(intrinsics, inds, H: int, W: int):
    """Unit camera-space directions [..., 3] for flat pixel indices."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    px = torch.div(inds, W, rounding_mode="floor")  # row
    py = inds % W  # col
    i = py.float() + 0.5
    j = px.float() + 0.5
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    zs = torch.ones_like(xs)
    norm = torch.sqrt(fma32(zs, zs, fma32(ys, ys, xs * xs)))
    return torch.stack([xs, ys, zs], dim=-1) / norm[..., None]


def rotate(dirs, rot):
    """dirs [..., 3] @ rot[:3, :3].T with XLA:CPU's FMA chain."""
    x0, x1, x2 = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    return fma32(x2, rot[:, 2], fma32(x1, rot[:, 1], x0 * rot[:, 0]))


def random_pixels(generator: torch.Generator, n_rays: int, H: int, W: int,
                  device=None):
    """[min(n_rays, H*W)] uniform flat pixel ids in [0, H*W)."""
    n = min(n_rays, H * W)
    return torch.randint(0, H * W, (n,), generator=generator, device=device)


ERROR_MAP_CELLS = 128 * 128  # a 128 x 128 grid of cells per image


def error_map_pixels(cells, jx, jy, H: int, W: int):
    """Flat pixel ids [N] of error-map cells [N] (row-major over 128 x
    128) with jitters jx, jy [N] in [0, 1): cell (ix, iy) spans rows
    [ix, ix + 1) * H / 128 and columns [iy, iy + 1) * W / 128
    (rays.py:75-80)."""
    ix = torch.div(cells, 128, rounding_mode="floor").float()
    iy = (cells % 128).float()
    sx, sy = H / 128.0, W / 128.0
    px = torch.clamp((ix * sx + jx * sx).to(torch.int32), 0, H - 1)
    py = torch.clamp((iy * sy + jy * sy).to(torch.int32), 0, W - 1)
    return px.long() * W + py.long()


def draw_error_map_pixels(generator: torch.Generator, emap_row, n_rays: int,
                          H: int, W: int):
    """(pixel ids [N], cells [N]) of N = min(n_rays, H*W) rays drawn by
    importance from one image's error map `emap_row` [128 * 128] on its
    device: the cells with replacement, with probability proportional to
    max(weight, 1e-12) (the JAX package's categorical over the log), then
    jx and jy, all from `generator`."""
    n = min(n_rays, H * W)
    w = torch.clamp_min(emap_row.float(), 1e-12)
    cells = torch.multinomial(w, n, replacement=True, generator=generator)
    jx = torch.rand(n, generator=generator, device=w.device)
    jy = torch.rand(n, generator=generator, device=w.device)
    return error_map_pixels(cells, jx, jy, H, W), cells


def draw_error_map_inds_np(rng: np.random.Generator, emap_row: np.ndarray,
                           H: int, W: int, n_rays: int):
    """The host flavor of the importance draw (rays.py:97-117), for the
    host batcher, which gathers the drawn pixels on the host.  Returns
    (inds [n_rays] int32 flat pixel ids, inds_coarse [n_rays] int32 cell
    ids)."""
    w = np.maximum(np.asarray(emap_row, np.float64), 1e-12)
    w = w / w.sum()
    inds_coarse = rng.choice(ERROR_MAP_CELLS, size=n_rays, replace=True,
                             p=w)
    ix, iy = inds_coarse // 128, inds_coarse % 128
    sx, sy = H / 128.0, W / 128.0
    jx = rng.random(n_rays)
    jy = rng.random(n_rays)
    px = np.clip((ix * sx + jx * sx).astype(np.int32), 0, H - 1)
    py = np.clip((iy * sy + jy * sy).astype(np.int32), 0, W - 1)
    return (px * W + py).astype(np.int32), inds_coarse.astype(np.int32)


def get_rays(poses, intrinsics, H: int, W: int, inds=None):
    """Rays for pixels `inds` ([N] flat ids; default the full image in
    scanline order) of each pose [B, 4, 4] c2w.

    Returns dict with rays_o, rays_d [B, N, 3] and inds [N].
    """
    poses = poses.float()
    if inds is None:
        inds = torch.arange(H * W, device=poses.device)
    dirs_cam = pixel_dirs(intrinsics, inds, H, W)  # [N, 3]
    rays_d = torch.stack([rotate(dirs_cam, p[:3, :3]) for p in poses])
    rays_o = poses[:, None, :3, 3].expand_as(rays_d)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}
