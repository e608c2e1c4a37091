"""Multi-resolution hash-grid encoding, INGP (port of pvd_tpu/ops/hashgrid.py).

`HashGridSpec` reproduces the JAX package's table layout exactly: per-level
offsets rounded up to 8 rows, `per_level_scale`, `level_scale`, and which
levels are hashed (hashgrid.py:37-143).  `hash_encode` is exact mode only
(no cell levels, no baked or packed dense tables: those are TPU gather
layouts of the same values).

Kernel K1 (`csrc/hash_encode.cu`) computes the forward encode on CUDA
tensors; `hash_encode_plain` is its PyTorch version, used for CPU tensors
and to check the kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pvd_tpu_torch import kernels
from pvd_tpu_torch.ops.fma import fma32

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Hash-grid layout; gridtype "hash", align_corners False (the field's
    setting in the JAX package)."""

    input_dim: int = 3
    num_levels: int = 14
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(np.exp2(np.log2(self.desired_resolution
                                     / self.base_resolution)
                             / (self.num_levels - 1)))

    @property
    def log2_per_level_scale(self) -> float:
        return float(np.log2(self.per_level_scale))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_scale(self, level: int) -> float:
        return float(np.exp2(level * self.log2_per_level_scale)
                     * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(np.ceil(self.level_scale(level))) + 1

    def level_side(self, level: int) -> int:
        """Vertices per axis of the level's lattice."""
        return self.level_resolution(level) + 1

    def level_is_hashed(self, level: int) -> bool:
        return self.level_side(level) ** self.input_dim \
            > 2 ** self.log2_hashmap_size

    @property
    def offsets(self) -> np.ndarray:
        """Cumulative level offsets [L+1] into the table, int64."""
        offsets, offset = [0], 0
        for lvl in range(self.num_levels):
            res = int(np.ceil(self.base_resolution
                              * self.per_level_scale ** lvl))
            n = min(2 ** self.log2_hashmap_size, (res + 1) ** self.input_dim)
            offset += int(np.ceil(n / 8) * 8)
            offsets.append(offset)
        return np.asarray(offsets, np.int64)

    @property
    def table_size(self) -> int:
        return int(self.offsets[-1])


def hash_encode_plain(table, x01, spec: HashGridSpec):
    """[N, D] positions in [0, 1] -> [N, L * C]; zero rows for inputs
    outside [0, 1]^D (hashgrid.py:533-688, exact mode)."""
    D, C = spec.input_dim, spec.level_dim
    x01 = x01.float()
    offsets = spec.offsets
    # any coordinate outside [0, 1] zeroes every level (hashgrid.py:571)
    okf = 1.0 - ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1).float()
    outs = []
    for level in range(spec.num_levels):
        off = int(offsets[level])
        size = int(offsets[level + 1]) - off
        side = spec.level_side(level)
        hashed = spec.level_is_hashed(level)
        pos = fma32(x01, np.float32(spec.level_scale(level)), 0.5)
        base = torch.floor(pos)
        frac = pos - base
        base_i = base.long()
        acc = torch.zeros(x01.shape[0], C, device=x01.device)
        for k in range(2 ** D):
            bit = [(k >> d) & 1 for d in range(D)]
            w = frac[:, 0] if bit[0] else 1.0 - frac[:, 0]
            for d in range(1, D):
                w = w * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
            w = w * okf
            c = [base_i[:, d] + bit[d] for d in range(D)]
            if hashed:
                row = c[0] * PRIMES[0]
                for d in range(1, D):
                    row = row ^ (c[d] * PRIMES[d])
                row = row & (2 ** spec.log2_hashmap_size - 1)
            else:
                row = c[0]
                for d in range(1, D):
                    row = row + c[d] * side ** d
                # only out-of-range inputs leave the level; their weight is 0
                row = row.clamp(0, size - 1)
            acc = acc + w[:, None] * table[off + row]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


@functools.cache
def _levels(spec: HashGridSpec) -> kernels.HashLevels:
    if spec.num_levels > kernels.MAX_LEVELS:
        raise ValueError(f"K1 supports at most {kernels.MAX_LEVELS} levels")
    lv = kernels.HashLevels()
    lv.n_levels = spec.num_levels
    lv.hash_mask = 2 ** spec.log2_hashmap_size - 1
    offsets = spec.offsets
    for level in range(spec.num_levels):
        lv.offset[level] = int(offsets[level])
        lv.side[level] = spec.level_side(level)
        lv.hashed[level] = int(spec.level_is_hashed(level))
        # rounded to f32 once from the float64 value, as JAX does when it
        # multiplies an f32 array by a Python float
        lv.scale[level] = float(np.float32(spec.level_scale(level)))
        size = int(offsets[level + 1] - offsets[level])
        if lv.hashed[level] and size != 2 ** spec.log2_hashmap_size:
            raise ValueError("hashed level size must be the power-of-two cap")
    return lv


def hash_encode(table, x01, spec: HashGridSpec):
    """Hash encode: K1 on CUDA tensors, the plain version on CPU tensors."""
    if x01.device.type == "cpu" and table.device.type == "cpu":
        return hash_encode_plain(table, x01, spec)
    kernels.check_cuda("hash_encode", table=table, x01=x01)
    kernels.check_no_grad("hash_encode", table, x01)
    if spec.input_dim != 3 or spec.level_dim != 2:
        raise NotImplementedError("K1 covers D=3, C=2 (ROADMAP B1: D=2)")
    if table.dtype != torch.float32 or x01.dtype != torch.float32:
        raise TypeError("hash_encode: table and x01 must be float32")
    if tuple(table.shape) != (spec.table_size, 2):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({spec.table_size}, 2)")
    if x01.ndim != 2 or x01.shape[1] != 3:
        raise ValueError(f"x01 must be [N, 3], got {tuple(x01.shape)}")
    if table.data_ptr() % 8:
        raise ValueError("hash_encode: table rows must be 8-byte aligned")
    n = x01.shape[0]
    out = torch.empty(n, spec.output_dim, device=x01.device)
    with torch.cuda.device(x01.device):
        kernels.launch("pvd_hash_encode_fwd", x01.data_ptr(),
                       table.data_ptr(), out.data_ptr(), n, _levels(spec),
                       kernels.stream_ptr(x01))
    hash_encode.launches += 1
    return out


hash_encode.launches = 0
