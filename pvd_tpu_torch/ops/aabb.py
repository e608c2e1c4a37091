"""Ray/AABB intersection (port of pvd_tpu/ops/aabb.py:15).

Slab test with a `min_near` floor; rays that miss carry FLT_MAX as both
near and far, so the march emits no sample for them.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MAX = float(np.float32(3.402823466e38))


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.2):
    """rays_o, rays_d: [..., 3] f32; aabb: [6] (min xyz, max xyz).
    Returns nears, fars [...]; both FLT_MAX where the ray misses."""
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    inv_d = 1.0 / rays_d  # IEEE inf for axis-parallel rays is fine
    lo = (aabb[:3] - rays_o) * inv_d
    hi = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = near.clamp_min(min_near)
    near = torch.where(miss, FLT_MAX, near)
    far = torch.where(miss, FLT_MAX, far)
    return near, far
