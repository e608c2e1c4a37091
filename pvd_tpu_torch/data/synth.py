"""Procedural test scene: analytic renders of colored spheres (port of
pvd_tpu/data/synth.py:18-118).

The JAX package writes the scene as a blender-format dataset (PNG files
and transforms JSON) that `data/provider.py:NeRFDataset` reads back.  This
port makes the same arrays in memory, with no files and no cv2: the same
ray-traced spheres in the same `default_rng(seed)` draw order across the
train, val and test splits, returned as NeRFDataset would read them:
  * images quantised to uint8 then divided by 255 (the PNG round trip);
  * poses in the NGP convention, `nerf_matrix_to_ngp(pose, scale)`;
  * intrinsics (fx, fy, cx, cy) with cx = H / 2 and cy = W / 2, the
    provider's quirk (provider.py:142-145).
Reading PNG datasets from disk is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pvd_tpu_torch.data.poses import pose_spherical
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp

SPHERES = [
    # (center, radius, rgb)
    (np.array([0.0, 0.0, 0.0]), 0.45, np.array([0.9, 0.25, 0.2])),
    (np.array([0.55, 0.3, 0.0]), 0.22, np.array([0.2, 0.8, 0.3])),
    (np.array([-0.5, -0.25, 0.3]), 0.18, np.array([0.25, 0.35, 0.95])),
]
CAMERA_ANGLE_X = 0.6911112070083618  # standard Synthetic-NeRF fov


@dataclasses.dataclass
class SceneSplit:
    """One split, with the attributes the Trainer reads (NeRFDataset's)."""

    poses: np.ndarray  # [B, 4, 4] float32, NGP convention
    images: np.ndarray  # [B, H, W, 4] float32 in [0, 1]
    intrinsics: np.ndarray  # (fx, fy, cx, cy) float32
    H: int
    W: int

    def __len__(self):
        return len(self.poses)

    def images_flat(self) -> np.ndarray:
        """[B, H*W, C] view for per-step pixel gathers."""
        B, H, W, C = self.images.shape
        return self.images.reshape(B, H * W, C)


def _render_analytic(pose: np.ndarray, H: int, W: int, focal: float,
                     textured: bool = False):
    """Ray-trace the opaque spheres; [H, W, 4] in [0, 1], blender camera
    convention (synth.py:26-80)."""
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1
    )
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rd = dirs @ pose[:3, :3].T
    ro = pose[:3, 3]

    best_t = np.full((H, W), np.inf)
    rgb = np.zeros((H, W, 3), np.float32)
    alpha = np.zeros((H, W), np.float32)
    light = np.array([0.577, 0.577, 0.577])
    for center, radius, color in SPHERES:
        oc = ro - center
        b = np.sum(rd * oc, axis=-1)
        c = np.sum(oc * oc) - radius * radius
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= (t > 0) & (t < best_t)
        p = ro + rd * t[..., None]
        n = (p - center) / radius
        shade = 0.55 + 0.45 * np.clip(-np.sum(n * rd, axis=-1), 0, 1)
        col = color[None, :] * shade[hit, None]
        if textured:
            ph = p[hit]
            tex = np.ones(ph.shape[0], np.float32)
            for freq, amp in ((11.0, 0.25), (29.0, 0.15), (71.0, 0.08)):
                tex *= 1.0 + amp * np.sin(freq * ph[:, 0]) * np.sin(
                    freq * ph[:, 1] + 1.3) * np.sin(freq * ph[:, 2] + 2.1)
            col = col * np.clip(tex, 0.3, 1.7)[:, None]
            hvec = light[None] - rd[hit]
            hvec /= np.linalg.norm(hvec, axis=-1, keepdims=True) + 1e-9
            spec = np.clip(np.sum(n[hit] * hvec, axis=-1), 0, 1) ** 48
            col = col + 0.6 * spec[:, None]
        rgb[hit] = np.clip(col, 0.0, 1.0).astype(np.float32)
        alpha[hit] = 1.0
        best_t[hit] = t[hit]
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def make_synthetic_scene(n_train: int = 12, n_val: int = 2, n_test: int = 3,
                         H: int = 64, W: int = 64, seed: int = 0,
                         textured: bool = False,
                         scale: float = 0.8) -> dict:
    """{"train", "val", "test"} -> SceneSplit; `scale` is the dataset's
    pose scale (`PVDConfig.scale`)."""
    rng = np.random.default_rng(seed)
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2))
    intrinsics = np.array([focal, focal, H / 2, W / 2], np.float32)
    splits = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        poses, images = [], []
        for _ in range(n):
            theta = rng.uniform(-180, 180)
            phi = rng.uniform(-60, -10)
            pose = pose_spherical(theta, phi, 4.0)
            img = _render_analytic(pose, H, W, focal, textured=textured)
            q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            images.append(q.astype(np.float32) / 255.0)
            poses.append(nerf_matrix_to_ngp(pose, scale=scale))
        splits[split] = SceneSplit(
            poses=np.stack(poses) if poses else np.zeros((0, 4, 4),
                                                         np.float32),
            images=np.stack(images) if images else np.zeros((0, H, W, 4),
                                                            np.float32),
            intrinsics=intrinsics, H=H, W=W)
    return splits
