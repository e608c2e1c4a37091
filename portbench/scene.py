"""The benchmark's inputs that are not weights: the cameras of a
NeRF-Synthetic-shaped scene and the fixed occupancy grids.

`pose_spherical` and `nerf_matrix_to_ngp` are copies of
`pvd_tpu_torch/data/poses.py:18` and `ops/rays.py:24`.
`surface_bitfield` and `object_like_bitfield` are copies of
`chip_smoke.py:650` and `chip_smoke.py:634`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CAMERA_ANGLE_X = 0.6911112070083618  # Synthetic-NeRF's field of view


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Blender-style spherical c2w [4, 4] float32."""
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


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float) -> np.ndarray:
    """Blender c2w -> NGP convention: axis cycle, y/z flip, t * scale."""
    return np.array(
        [[pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale],
         [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale],
         [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale],
         [0, 0, 0, 1]], dtype=np.float32)


def focal_of(W: int) -> float:
    return W / (2.0 * np.tan(CAMERA_ANGLE_X / 2))


def intrinsics(H: int, W: int) -> np.ndarray:
    """(fx, fy, cx, cy) as the port's provider gives them (cx = H / 2,
    cy = W / 2)."""
    f = focal_of(W)
    return np.array([f, f, H / 2, W / 2], np.float32)


def orbit_poses(n: int, phi_deg: float, start_deg: float) -> np.ndarray:
    """n blender cameras evenly spaced in azimuth at one elevation, the
    first at `start_deg`."""
    return np.stack([pose_spherical(start_deg + 360.0 * k / n, phi_deg, 4.0)
                     for k in range(n)])


def surface_bitfield(H: int) -> np.ndarray:
    """Deterministic surface-like occupancy: a thin spherical shell (radius
    0.4, ~1 cell thick) and two thin blob shells, 0.27% of cells.  A
    train-mode march from the test orbit takes ~8 valid samples per ray,
    about the batch mean of a trained grid."""
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = np.abs(np.sqrt(X**2 + Y**2 + Z**2) - 0.4) < 0.005
    rng = np.random.default_rng(7)
    for _ in range(2):
        c = rng.uniform(-0.25, 0.25, 3)
        rad = rng.uniform(0.06, 0.12)
        r = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
        g |= np.abs(r - rad) < 0.005
    return g.reshape(-1)


def object_like_bitfield(H: int) -> np.ndarray:
    """Deterministic 3.18% occupancy clustered like a trained object grid:
    a thick spherical shell plus a few solid blobs near the center."""
    g = np.zeros((H, H, H), bool)
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X**2 + Y**2 + Z**2)
    g |= (r > 0.42) & (r < 0.5)
    rng = np.random.default_rng(7)
    for _ in range(6):
        c = rng.uniform(-0.3, 0.3, 3)
        rad = rng.uniform(0.08, 0.16)
        g |= ((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) < rad**2
    return g.reshape(-1)


BITFIELDS = {"surface": surface_bitfield, "object_like": object_like_bitfield}


@dataclasses.dataclass
class Split:
    """One training split with the attributes the program's Trainer reads
    (`poses` in the NGP convention, `images` on the host, `intrinsics`,
    `H`, `W`)."""

    poses: np.ndarray
    images: np.ndarray | None
    intrinsics: np.ndarray
    H: int
    W: int

    def __len__(self):
        return len(self.poses)
