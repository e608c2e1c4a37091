"""Blender-format dataset reader (port of pvd_tpu/data/provider.py).

Reads `transforms_{split}.json` and its frames with the port's PNG codec
(`data/png.py`, no cv2): RGB(A) in [0, 1] as float32, poses converted with
`nerf_matrix_to_ngp(scale=cfg.scale)`, and pinhole intrinsics from
`fl_x`/`fl_y` or `camera_angle_x`/`camera_angle_y`.  Frames whose file is
missing are skipped; a `file_path` without a .png/.jpg suffix gets .png.
The splits "all" (every transforms JSON in the directory) and "trainval"
(train, then val) are read as the JAX package reads them.  JPEG frames
are not read (ROADMAP A15): the codec raises on them.

A `NeRFDataset` has the attributes the Trainer reads from the port's
in-memory scenes (`data/synth.SceneSplit`): poses, images, intrinsics, H,
W, `images_flat()` and `len()`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.png import read_png
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp


def imread(path: str) -> np.ndarray:
    """[H, W, 3|4] uint8, RGB(A), as the JAX package's cv2 reader returns
    it: grey becomes RGB, grey + alpha RGBA."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    if img.shape[-1] in (1, 2):
        img = np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1)
    return img


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] overlap of each input pixel with each output pixel's
    span of n_in / n_out input pixels, over that span."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(j + 1, lo + s) - np.maximum(j, lo), 0, None)
    return overlap / s


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """`cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)` on uint8.

    Integer factors f (the provider's `downscale` on a divisible size),
    as cv2 computes them: the sum of each f x f block, then (sum + 2) >> 2
    for f = 2, else float32(sum) * float32(1 / f^2) rounded half to even:
    equal to cv2 bit for bit.  Other factors: each output pixel is the mean
    of the input pixels it covers, weighted by their overlap (cv2's area
    weights), in float64 and rounded half to even; cv2 sums in float32, so
    a pixel may differ from its result by one level."""
    h, w = img.shape[:2]
    if (H, W) == (h, w):
        return img
    if h % H == 0 and w % W == 0 and h // H == w // W:
        f = h // H
        s = img.reshape(H, f, W, f, -1).astype(np.int64).sum((1, 3))
        if f == 2:
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (f * f)))
    else:
        out = np.rint(np.einsum("yi,ijc,xj->yxc", _area_weights(h, H),
                                img.reshape(h, w, -1).astype(np.float64),
                                _area_weights(w, W)))
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (H, W) + img.shape[2:])


class NeRFDataset:
    """One split of a blender-format scene at `cfg.path`.

    Attributes:
      poses: [B, 4, 4] float32 (NGP convention)
      images: [B, H, W, C] float32 in [0, 1] (C = 3 or 4)
      intrinsics: (fx, fy, cx, cy) float32
      radius: mean camera distance from the origin
      error_map: [B, 128 * 128] float32 of ones for a training split with
        `cfg.error_map`, else None
    """

    def __init__(self, cfg: PVDConfig, split: str = "train",
                 downscale: int = 1):
        root = cfg.path
        if cfg.mode != "blender":
            raise NotImplementedError(f"unknown dataset mode: {cfg.mode}")
        transform = self._load_transforms(root, split)
        self.H = int(transform["h"]) // downscale if "h" in transform \
            else None
        self.W = int(transform["w"]) // downscale if "w" in transform \
            else None

        poses, images = [], []
        for f in transform["frames"]:
            fpath = os.path.join(root, f["file_path"])
            if fpath[-4:].lower() not in (".png", ".jpg"):
                fpath += ".png"
            if not os.path.exists(fpath):
                continue
            pose = np.array(f["transform_matrix"], np.float32)
            poses.append(nerf_matrix_to_ngp(pose, scale=cfg.scale))
            img = imread(fpath)
            if self.H is None:
                self.H = img.shape[0] // downscale
                self.W = img.shape[1] // downscale
            img = resize_area(img, self.H, self.W)
            images.append(img.astype(np.float32) / 255.0)
        if not poses:
            raise RuntimeError(f"no frames found for split '{split}' in "
                               f"{root}")
        self.poses = np.stack(poses)
        self.images = np.stack(images)
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                           axis=-1).mean())
        training = split in ("train", "all", "trainval")
        self.error_map = (np.ones((len(self.poses), 128 * 128), np.float32)
                          if training and cfg.error_map else None)
        self.intrinsics = self._intrinsics(transform, downscale)

    @staticmethod
    def _load_transforms(root: str, split: str) -> dict:
        if split == "all":
            transform = None
            for p in sorted(glob.glob(os.path.join(root, "*.json"))):
                with open(p) as f:
                    t = json.load(f)
                if transform is None:
                    transform = t
                else:
                    transform["frames"].extend(t["frames"])
            if transform is None:
                raise FileNotFoundError(f"no transforms json in {root}")
            return transform
        if split == "trainval":
            with open(os.path.join(root, "transforms_train.json")) as f:
                transform = json.load(f)
            with open(os.path.join(root, "transforms_val.json")) as f:
                transform["frames"].extend(json.load(f)["frames"])
            return transform
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            return json.load(f)

    def _intrinsics(self, transform: dict, downscale: int) -> np.ndarray:
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = fl_y = None
            if "camera_angle_x" in transform:
                fl_x = self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
            if "camera_angle_y" in transform:
                fl_y = self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("transforms.json lacks focal length info")
        # the JAX package's quirk (provider.py:138-141): cx defaults to
        # H / 2 and cy to W / 2
        cx = transform.get("cx", self.H / 2) / (downscale if "cx" in transform
                                                else 1)
        cy = transform.get("cy", self.W / 2) / (downscale if "cy" in transform
                                                else 1)
        return np.array([fl_x, fl_y, cx, cy], np.float32)

    def __len__(self):
        return len(self.poses)

    def images_flat(self) -> Optional[np.ndarray]:
        """[B, H*W, C] view for the per-step pixel gathers."""
        B, H, W, C = self.images.shape
        return self.images.reshape(B, H * W, C)
