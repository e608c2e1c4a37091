"""Camera rays and pose conventions (port of pvd_tpu/ops/rays.py:16-94).

Full-image rays, or rays at pixel ids drawn uniformly from an explicit
`torch.Generator` (`random_pixels`, the draw of get_rays in rays.py:63-67);
the error-map draw is not ported yet (ROADMAP A16).  The norm and the
rotation use `fma32` where XLA:CPU contracts them (ops/fma.py), so the
port's rays equal the JAX package's bit for bit.
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
