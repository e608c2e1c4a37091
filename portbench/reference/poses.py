"""The distillation epoch's cameras: a copy of
`pvd_tpu_torch/data/poses.py:40-69` (`get_rand_poses` for synthetic
data: one pose at elevation 8, then (90 - a) // 15 + 1 poses at each
elevation a in [0, 80), radius 4, NGP convention at scale 0.8), which the
Trainer draws from `np.random.default_rng(seed)` at the start of `train`."""

from __future__ import annotations

import numpy as np

from portbench.scene import nerf_matrix_to_ngp, pose_spherical


def _sample(rng, elevation: float) -> np.ndarray:
    theta = rng.uniform(-180.0, 180.0)
    phi = rng.uniform(-elevation, min(5.0 - elevation, 0.0))
    return pose_spherical(theta, phi, 4.0)


def distill_epoch_poses(seed: int) -> np.ndarray:
    rng = np.random.default_rng(int(seed))
    poses = [_sample(rng, 8.0)]
    for a in range(0, 80):
        poses.extend(_sample(rng, float(a)) for _ in range((90 - a) // 15 + 1))
    return np.stack([nerf_matrix_to_ngp(p, scale=0.8) for p in poses])
