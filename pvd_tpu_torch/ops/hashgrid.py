"""Multi-resolution hash-grid encoding, INGP (port of pvd_tpu/ops/hashgrid.py).

`HashGridSpec` reproduces the JAX package's table layout exactly: per-level
offsets rounded up to 8 rows, `per_level_scale`, `level_scale`, and which
levels are hashed (hashgrid.py:37-143).  `hash_encode` is exact mode only
(no cell levels, no baked or packed dense tables: those are TPU gather
layouts of the same values).

`hash_encode` is differentiable in the table through an autograd
Function: kernel K1 (`csrc/hash_encode.cu`) computes the forward encode and
kernel K7 the table gradient on CUDA tensors; `hash_encode_plain` and
`hash_encode_bwd_plain` are their PyTorch versions, used for CPU tensors
and to check the kernels.  Positions carry no gradient (they come from the
march), so the JAX package's gradient into the corner weights (`g_w` of
`_corner_gather_sum_bwd`) has no counterpart here.
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


def level_corners(x01, spec: HashGridSpec, level: int):
    """Weights [2^D, N] and absolute table rows [2^D, N] of one level's
    corners, exactly as the kernels form them; out-of-range inputs get
    weight 0 (hashgrid.py:571) and an in-range row."""
    D = spec.input_dim
    offsets = spec.offsets
    off = int(offsets[level])
    size = int(offsets[level + 1]) - off
    side = spec.level_side(level)
    okf = 1.0 - ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1).float()
    pos = fma32(x01, np.float32(spec.level_scale(level)), 0.5)
    base = torch.floor(pos)
    frac = pos - base
    base_i = base.long()
    ws, rows = [], []
    for k in range(2 ** D):
        bit = [(k >> d) & 1 for d in range(D)]
        w = frac[:, 0] if bit[0] else 1.0 - frac[:, 0]
        for d in range(1, D):
            w = w * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
        c = [base_i[:, d] + bit[d] for d in range(D)]
        if spec.level_is_hashed(level):
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
        ws.append(w * okf)
        rows.append(off + row)
    return torch.stack(ws), torch.stack(rows)


def hash_encode_plain(table, x01, spec: HashGridSpec):
    """[N, D] positions in [0, 1] -> [N, L * C]; zero rows for inputs
    outside [0, 1]^D (hashgrid.py:533-688, exact mode)."""
    x01 = x01.float()
    N, C = x01.shape[0], spec.level_dim
    outs = []
    for level in range(spec.num_levels):
        w, rows = level_corners(x01, spec, level)
        vals = table.index_select(0, rows.reshape(-1)).reshape(-1, N, C)
        acc = torch.zeros(N, C, device=x01.device)
        for k in range(w.shape[0]):
            acc = acc + w[k, :, None] * vals[k]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def hash_encode_bwd_plain(x01, g, spec: HashGridSpec):
    """Table gradient [T, C] of `hash_encode` for the upstream gradient
    g [N, L * C]: g_table[row] += w * g per corner (index_add_), the
    scatter of hashgrid.py:284 `_corner_gather_sum_bwd` and of the packed
    dense gather's autodiff."""
    x01 = x01.float()
    C = spec.level_dim
    g = g.float().reshape(x01.shape[0], spec.num_levels, C)
    grad = torch.zeros(spec.table_size, C, device=x01.device)
    for level in range(spec.num_levels):
        w, rows = level_corners(x01, spec, level)
        grad.index_add_(0, rows.reshape(-1),
                        (w[:, :, None] * g[None, :, level]).reshape(-1, C))
    return grad


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


def _check_k1(name, spec: HashGridSpec, x01, **tensors):
    dev = kernels.check_cuda(name, x01=x01, **tensors)
    if spec.input_dim != 3 or spec.level_dim != 2:
        raise NotImplementedError("K1/K7 cover D=3, C=2 (ROADMAP B1: D=2)")
    if x01.dtype != torch.float32 or \
            any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError(f"{name}: tensors must be float32")
    if x01.ndim != 2 or x01.shape[1] != 3:
        raise ValueError(f"x01 must be [N, 3], got {tuple(x01.shape)}")
    return dev


def hash_encode_fwd(table, x01, spec: HashGridSpec):
    """Forward encode, no autograd: K1 on CUDA tensors, the plain version
    on CPU tensors."""
    if x01.device.type == "cpu" and table.device.type == "cpu":
        return hash_encode_plain(table, x01, spec)
    _check_k1("hash_encode", spec, x01, table=table)
    if tuple(table.shape) != (spec.table_size, 2):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({spec.table_size}, 2)")
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


def hash_encode_bwd(x01, g, spec: HashGridSpec):
    """Table gradient [T, 2] for the upstream gradient g [N, L * 2]: K7 on
    CUDA tensors, the plain version on CPU tensors."""
    if x01.device.type == "cpu" and g.device.type == "cpu":
        return hash_encode_bwd_plain(x01, g, spec)
    _check_k1("hash_encode_bwd", spec, x01, g=g)
    if tuple(g.shape) != (x01.shape[0], spec.output_dim):
        raise ValueError(f"g must be [{x01.shape[0]}, {spec.output_dim}], "
                         f"got {tuple(g.shape)}")
    grad = torch.zeros(spec.table_size, 2, device=x01.device)
    with torch.cuda.device(x01.device):
        kernels.launch("pvd_hash_encode_bwd", x01.data_ptr(), g.data_ptr(),
                       grad.data_ptr(), x01.shape[0], _levels(spec),
                       kernels.stream_ptr(x01))
    hash_encode_bwd.launches += 1
    return grad


hash_encode_bwd.launches = 0


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x01, spec):
        ctx.save_for_backward(x01)
        ctx.spec = spec
        return hash_encode_fwd(table, x01, spec)

    @staticmethod
    def backward(ctx, g):
        (x01,) = ctx.saved_tensors
        return hash_encode_bwd(x01, g.contiguous(), ctx.spec), None, None


def hash_encode(table, x01, spec: HashGridSpec):
    """Hash encode [N, 3] positions in [0, 1] -> [N, L * C],
    differentiable in `table` (forward K1, backward K7 on CUDA tensors;
    the plain versions on CPU tensors).  `x01` takes no gradient: it must
    not require one while grad mode is on."""
    if not torch.is_grad_enabled():
        return hash_encode_fwd(table, x01, spec)
    if x01.requires_grad:
        raise NotImplementedError(
            "hash_encode: no gradient into the positions (they come from "
            "the march); detach x01")
    if table.requires_grad:
        return _HashEncode.apply(table, x01, spec)
    return hash_encode_fwd(table, x01, spec)


hash_encode.launches = 0
