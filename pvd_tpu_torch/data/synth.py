"""Procedural test scene: analytic renders of colored spheres (port of
pvd_tpu/data/synth.py:18-118).

The same ray-traced spheres in the same `default_rng(seed)` draw order
across the train, val and test splits, two ways:
  * `write_synthetic_scene(root, ...)` writes them as the JAX package's
    `make_synthetic_scene(root, ...)` does: a blender-format dataset of
    RGBA PNG files (`data/png.py`, no cv2) and `transforms_{split}.json`,
    for `data/provider.NeRFDataset` to read back;
  * `make_synthetic_scene(...)` returns the arrays in memory, as
    NeRFDataset would read them: images quantised to uint8 then divided
    by 255 (the PNG round trip), poses in the NGP convention
    (`nerf_matrix_to_ngp(pose, scale)`), intrinsics (fx, fy, cx, cy) with
    cx = H / 2 and cy = W / 2, the provider's quirk (provider.py:142-145).

With `sky_radius` > 0 the scene is an unbounded one, as the large-scene
configuration (bound > 1, the background model) expects: each image is
composited over an analytic sky dome of that radius around the origin and
returned as RGB.  The JAX package's scene has no such option; with its
white background a background model cannot tell empty space from white
floaters, and the outer occupancy cascade fills with them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from pvd_tpu_torch.data.png import write_png
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
    images: np.ndarray  # [B, H, W, 4] (RGB: 3) float32 in [0, 1]
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


def _sky(pose: np.ndarray, H: int, W: int, focal: float,
         radius: float) -> np.ndarray:
    """[H, W, 3] color of the dome of `radius` (blender units, z up) where
    each pixel's ray leaves it: a ground-to-zenith gradient by elevation,
    modulated by broad bands in azimuth and elevation."""
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1
    )
    rd = dirs @ pose[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = pose[:3, 3]
    b = rd @ ro
    t = -b + np.sqrt(b * b - (ro @ ro - radius * radius))
    p = (ro + rd * t[..., None]) / radius
    up = np.clip((p[..., 2] + 0.3) / 0.7, 0.0, 1.0)
    up = up * up * (3.0 - 2.0 * up)
    ground = np.array([0.55, 0.45, 0.35])
    zenith = np.array([0.35, 0.6, 0.95])
    sky = ground + (zenith - ground) * up[..., None]
    az = np.arctan2(p[..., 1], p[..., 0])
    bands = 1.0 + 0.25 * np.sin(4.0 * az) * np.cos(3.0 * np.pi * p[..., 2])
    return np.clip(sky * bands[..., None], 0.0, 1.0)


def _frames(counts: dict, H: int, W: int, seed: int, textured: bool,
            sky_radius: float = 0.0):
    """(split, k, blender pose [4, 4] float32, uint8 image [H, W, 4], RGB
    over the sky when sky_radius > 0) in the JAX package's draw order."""
    rng = np.random.default_rng(seed)
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2))
    for split, n in counts.items():
        for k in range(n):
            theta = rng.uniform(-180, 180)
            phi = rng.uniform(-60, -10)
            pose = pose_spherical(theta, phi, 4.0)
            img = _render_analytic(pose, H, W, focal, textured=textured)
            if sky_radius > 0:
                img = (img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
                       * _sky(pose, H, W, focal, sky_radius))
            yield split, k, pose, (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_synthetic_scene(root: str, n_train: int = 12, n_val: int = 2,
                          n_test: int = 3, H: int = 64, W: int = 64,
                          seed: int = 0, textured: bool = False) -> str:
    """Write the scene to `root` as the JAX package's
    `make_synthetic_scene(root, ...)` does (synth.py:84-118): the same
    frames, poses, camera_angle_x and pixels.  Returns root."""
    counts = {"train": n_train, "val": n_val, "test": n_test}
    frames = {split: [] for split in counts}
    for split in counts:
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for split, k, pose, img in _frames(counts, H, W, seed, textured):
        fname = f"./{split}/r_{k}"
        frames[split].append({"file_path": fname,
                              "transform_matrix": pose.tolist()})
        write_png(os.path.join(root, f"{split}/r_{k}.png"), img)
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": fr}, f)
    return root


def make_synthetic_scene(n_train: int = 12, n_val: int = 2, n_test: int = 3,
                         H: int = 64, W: int = 64, seed: int = 0,
                         textured: bool = False, scale: float = 0.8,
                         sky_radius: float = 0.0) -> dict:
    """{"train", "val", "test"} -> SceneSplit; `scale` is the dataset's
    pose scale (`PVDConfig.scale`).  `sky_radius` > 0: RGB images over a
    sky dome of that radius in blender units (bg_radius / scale puts it on
    the background model's sphere); else RGBA on nothing."""
    counts = {"train": n_train, "val": n_val, "test": n_test}
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2))
    intrinsics = np.array([focal, focal, H / 2, W / 2], np.float32)
    poses = {split: [] for split in counts}
    images = {split: [] for split in counts}
    for split, _, pose, q in _frames(counts, H, W, seed, textured,
                                     sky_radius):
        images[split].append(q.astype(np.float32) / 255.0)
        poses[split].append(nerf_matrix_to_ngp(pose, scale=scale))
    C = 3 if sky_radius > 0 else 4
    return {split: SceneSplit(
        poses=np.stack(poses[split]) if poses[split]
        else np.zeros((0, 4, 4), np.float32),
        images=np.stack(images[split]) if images[split]
        else np.zeros((0, H, W, C), np.float32),
        intrinsics=intrinsics, H=H, W=W) for split in counts}
