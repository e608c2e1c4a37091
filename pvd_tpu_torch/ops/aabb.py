"""Ray/AABB intersection and background-sphere polar coordinates (port of
pvd_tpu/ops/aabb.py:15-55).

Slab test with a `min_near` floor; rays that miss carry FLT_MAX as both
near and far, so the march emits no sample for them.  `polar_from_ray`
maps where a ray leaves the background sphere to (theta, phi) in [-1, 1]^2,
the background model's input (`polar01_from_ray`: the same in [0, 1]^2).  Both are elementwise passes per ray that
take no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from pvd_tpu_torch.ops.fma import fma32

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


def _dot3(u, v):
    """sum(u * v, -1) over 3 components as XLA:CPU's FMA chain."""
    return fma32(u[..., 2], v[..., 2],
                 fma32(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))


def _polar_angles(rays_o, rays_d, radius: float):
    """(theta, phi) of the point where each ray leaves the sphere, in the
    JAX package's op order (aabb.py:42-55): b is B/2, theta = atan2 of
    (|xz|, y), phi = atan2(z, x).  The products that XLA:CPU contracts into
    FMAs under jit (the dot products, the discriminant b*b - a*c, the exit
    point o + t*d and x*x + z*z) are FMAs here too (`ops/fma.py`)."""
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    a = _dot3(rays_d, rays_d)
    b = _dot3(rays_o, rays_d)  # B/2
    c = _dot3(rays_o, rays_o) - radius * radius
    disc = torch.clamp_min(fma32(b, b, -(a * c)), 0.0)
    t = (-b + torch.sqrt(disc)) / a
    p = fma32(t[..., None], rays_d, rays_o)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(fma32(x, x, z * z)), y)  # [0, pi]
    phi = torch.atan2(z, x)  # [-pi, pi]
    return theta, phi


_INV_PI = float(np.float32(1.0 / np.pi))


def polar_from_ray(rays_o, rays_d, radius: float):
    """Ray ∩ sphere(radius) -> (theta, phi) in [-1, 1]^2 [..., 2]:
    (2 theta / pi - 1 as one FMA, phi / pi)."""
    theta, phi = _polar_angles(rays_o, rays_d, radius)
    return torch.stack([fma32(2.0 * theta, _INV_PI, -1.0), phi * _INV_PI],
                       dim=-1)


def polar01_from_ray(rays_o, rays_d, radius: float):
    """(polar_from_ray + 1) / 2 in [0, 1]^2, the background encode's input,
    rounded as XLA:CPU computes it inside a jitted render, where it fuses
    phi / pi + 1 into one FMA.  The finest background level has 2048 cells
    per unit, so a 1-ulp change of this coordinate moves a corner weight by
    ~1e-4; this keeps the port's background on the JAX package's bits for
    all but ~0.1% of rays (XLA's division is not always correctly
    rounded)."""
    theta, phi = _polar_angles(rays_o, rays_d, radius)
    return torch.stack([(fma32(2.0 * theta, _INV_PI, -1.0) + 1.0) * 0.5,
                        fma32(phi, _INV_PI, 1.0) * 0.5], dim=-1)
