"""Camera poses (port of pvd_tpu/data/poses.py).

Host-side numpy: `pose_spherical` gives the blender-style orbit c2w that
the synthetic scene and the test orbit use; `get_rand_poses` draws one
distillation epoch's fresh viewpoints (synthetic, tank, llff) and
`rand_orbit_poses` the `rand_pose` orbit cameras, with the same
`np.random.Generator` draws in the same order as the JAX package, so one
seed gives the same poses in both.
"""

from __future__ import annotations

import numpy as np

from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Blender-style spherical c2w [4, 4] float32
    (distill_mutual/utils.py:67-98 in the reference)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi = phi_deg / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(phi), -np.sin(phi), 0],
                        [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]],
                       np.float32)
    th = theta_deg / 180.0 * np.pi
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]],
                         np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ rot_theta @ rot_phi @ c2w


def _sample_sphere_pose(rng: np.random.Generator, elevation: float,
                        rand_radius: bool) -> np.ndarray:
    theta = rng.uniform(-180.0, 180.0)
    phi_hi = min(5.0 - elevation, 0.0)
    phi = rng.uniform(-elevation, phi_hi)
    radius = rng.uniform(3.0, 4.0) if rand_radius else 4.0
    return pose_spherical(theta, phi, radius)


def _elevation_sweep(rng, lo: int, hi: int, rand_radius: bool) -> np.ndarray:
    """One pose at elevation 8, then (90 - a) // 15 + 1 poses at each
    elevation a in [lo, hi): more near the horizon (poses.py:63-69)."""
    poses = [_sample_sphere_pose(rng, 8.0, rand_radius)]
    for a in range(lo, hi):
        count = (90 - a) // 15 + 1
        poses.extend(_sample_sphere_pose(rng, float(a), rand_radius)
                     for _ in range(count))
    return np.stack([nerf_matrix_to_ngp(p, scale=0.8) for p in poses])


def _lookat_origin_poses(centers: np.ndarray) -> np.ndarray:
    """c2w matrices looking from `centers` at the origin, up (0, -1, 0)
    (poses.py:72-87)."""
    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    fwd = -normalize(centers)
    up = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (len(centers), 1))
    right = normalize(np.cross(fwd, up))
    up = normalize(np.cross(right, fwd))
    poses = np.tile(np.eye(4, dtype=np.float32), (len(centers), 1, 1))
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up
    poses[:, :3, 2] = fwd
    poses[:, :3, 3] = centers
    return poses


def rand_orbit_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
                     theta_range=(np.pi / 3, 2 * np.pi / 3),
                     phi_range=(0.0, 2 * np.pi)) -> np.ndarray:
    """Orbit cameras looking at the origin (poses.py:90-105), for the
    `rand_pose` augmentation."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    centers = np.stack([radius * np.sin(thetas) * np.sin(phis),
                        radius * np.cos(thetas),
                        radius * np.sin(thetas) * np.cos(phis)],
                       axis=-1).astype(np.float32)
    return _lookat_origin_poses(centers)


def get_rand_poses(rng: np.random.Generator, data_type: str = "synthetic",
                   train_poses: np.ndarray | None = None) -> np.ndarray:
    """Fresh distillation viewpoints for one epoch (poses.py:108-127):
    synthetic, the elevation sweep at radius 4 (312 poses); tank, the
    sweep over [5, 20) at radius U(3, 4); llff, 30 cameras uniform in the
    training cameras' box (`train_poses` [B, 4, 4], NGP convention),
    looking at the origin."""
    if data_type == "synthetic":
        return _elevation_sweep(rng, 0, 80, rand_radius=False)
    if data_type == "tank":
        return _elevation_sweep(rng, 5, 20, rand_radius=True)
    if data_type == "llff":
        if train_poses is None:
            raise ValueError("llff pose sampling needs the train poses")
        t = train_poses[:, :3, 3]
        lo, hi = t.min(axis=0) - 1e-6, t.max(axis=0) + 1e-6
        centers = rng.uniform(lo, hi, size=(30, 3)).astype(np.float32)
        poses = _lookat_origin_poses(centers)
        poses[:, 0, 0] = -poses[:, 0, 0]  # the reference's llff handedness
        return poses
    raise ValueError(f"unknown data_type: {data_type}")
