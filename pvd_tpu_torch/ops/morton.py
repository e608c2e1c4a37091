"""Morton (Z-order) 3D codes in torch integer ops (port of
pvd_tpu/ops/morton.py).

The reference stores its density grid in Morton order
(raymarching.cu:58-83); the port, like the JAX package, keeps grids
row-major [H, H, H].  These functions translate between the two for
checkpoint interop (`render/occupancy.to_morton_order` /
`from_morton_order`, `engine/import_torch.py`).  The JAX package's
uint32 arithmetic is done in int64 with 32-bit masks: coordinates are
below 1024, so every product is exact before its mask.
"""

from __future__ import annotations

import torch


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """coords: [..., 3] integers in [0, 1024).  Returns [...] int64 Morton
    codes: bit 3k of x, 3k + 1 of y and 3k + 2 of z hold bit k of each
    coordinate."""
    coords = torch.as_tensor(coords).long()
    return (_expand_bits(coords[..., 0])
            | (_expand_bits(coords[..., 1]) << 1)
            | (_expand_bits(coords[..., 2]) << 2))


def _compact_bits(x):
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes):
    """codes: [...] integers below 2^30.  Returns [..., 3] int64 (x, y, z)
    (the JAX package returns int32)."""
    codes = torch.as_tensor(codes).long()
    return torch.stack([_compact_bits(codes), _compact_bits(codes >> 1),
                        _compact_bits(codes >> 2)], dim=-1)
