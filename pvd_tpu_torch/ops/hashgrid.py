"""Multi-resolution hash-grid encoding, INGP (port of pvd_tpu/ops/hashgrid.py).

`HashGridSpec` reproduces the JAX package's table layout exactly: per-level
offsets rounded up to 8 rows, `per_level_scale`, `level_scale`, which
levels are hashed, and the cell-packed levels (hashgrid.py:37-143).  With
`n_cell_levels` > 0 the finest hashed levels are cell levels: each lattice
cell's 2^D corner features sit in one row of a separate cell table
[n_cell * 2^(log2_hashmap_size - D), 2^D * C], hashed by the cell's base
coordinate, and those levels take no rows of the corner table.  The JAX
package's packed and baked dense tables are TPU gather layouts of the same
values and are not ported.

`hash_encode` is differentiable in both tables through one autograd
Function.  On CUDA tensors kernel K1 (`csrc/hash_encode.cu`) encodes the
corner levels and K10 the cell levels into one output; K7 computes the
corner table's gradient and K11 the cell table's.  A 2-D grid (input_dim
2, the background model's, which has no cell levels) goes through K12
(encode) and K13 (table gradient) instead.  `hash_encode_plain`,
`hash_encode_cell_plain`, `hash_encode_bwd_plain` and
`hash_encode_cell_bwd_plain` are their PyTorch versions, used for CPU
tensors and to check the kernels.  Positions carry no gradient (they come
from the march), so the JAX package's gradient into the corner weights
(`g_w` of `_corner_gather_sum_bwd` and `_cell_gather_sum_bwd`) has no
counterpart here.
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
    n_cell_levels: int = 0

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

    def is_cell_level(self, level: int) -> bool:
        return (self.n_cell_levels > 0
                and level >= self.num_levels - self.n_cell_levels
                and self.level_is_hashed(level))

    # derived lists are cached: the wrappers read them on every call
    @functools.cached_property
    def cell_levels(self) -> list:
        return [lv for lv in range(self.num_levels) if self.is_cell_level(lv)]

    @functools.cached_property
    def corner_levels(self) -> list:
        """The levels read from the corner table (all but the cell ones)."""
        return [lv for lv in range(self.num_levels)
                if not self.is_cell_level(lv)]

    @functools.cached_property
    def dense_levels(self) -> list:
        """The levels a bake merges (`baked_dense_plan`, hashgrid.py:451):
        the dense corner levels of a 3-D grid; the last is the finest."""
        if self.input_dim != 3:
            return []
        return [lv for lv in self.corner_levels
                if not self.level_is_hashed(lv)]

    @functools.cached_property
    def unbaked_levels(self) -> list:
        """The corner levels a baked encode still reads from the table."""
        return [lv for lv in self.corner_levels
                if lv not in self.dense_levels]

    @property
    def log2_cell_size(self) -> int:
        return self.log2_hashmap_size - self.input_dim

    @property
    def cell_rows_per_level(self) -> int:
        return 2 ** self.log2_cell_size

    @property
    def cell_table_size(self) -> int:
        return len(self.cell_levels) * self.cell_rows_per_level

    @property
    def cell_row_width(self) -> int:
        return 2 ** self.input_dim * self.level_dim

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """Cumulative level offsets [L+1] into the corner table, int64;
        cell levels take no rows."""
        offsets, offset = [0], 0
        for lvl in range(self.num_levels):
            if not self.is_cell_level(lvl):
                res = int(np.ceil(self.base_resolution
                                  * self.per_level_scale ** lvl))
                n = min(2 ** self.log2_hashmap_size,
                        (res + 1) ** self.input_dim)
                offset += int(np.ceil(n / 8) * 8)
            offsets.append(offset)
        return np.asarray(offsets, np.int64)

    @property
    def table_size(self) -> int:
        return int(self.offsets[-1])


def _lattice(x01, spec: HashGridSpec, level: int):
    """The level's lattice base (int64) and fractions of each point, and
    okf, 0.0 for points outside [0, 1]^D (hashgrid.py:571, 591-601)."""
    okf = 1.0 - ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1).float()
    pos = fma32(x01, np.float32(spec.level_scale(level)), 0.5)
    base = torch.floor(pos)
    return base.long(), pos - base, okf


def _corner_weights(frac, okf, D: int):
    """d-linear weights [2^D, N] in corner order (bit d of the corner id:
    +1 along dim d), zero for points outside the cube."""
    ws = []
    for k in range(2 ** D):
        bit = [(k >> d) & 1 for d in range(D)]
        w = frac[:, 0] if bit[0] else 1.0 - frac[:, 0]
        for d in range(1, D):
            w = w * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
        ws.append(w * okf)
    return torch.stack(ws)


def _xor_hash(c, D: int):
    row = c[0] * PRIMES[0]
    for d in range(1, D):
        row = row ^ (c[d] * PRIMES[d])
    return row


def level_corners(x01, spec: HashGridSpec, level: int):
    """Weights [2^D, N] and absolute corner-table rows [2^D, N] of one
    corner level, exactly as the kernels form them; out-of-range inputs get
    weight 0 and an in-range row."""
    D = spec.input_dim
    offsets = spec.offsets
    off = int(offsets[level])
    size = int(offsets[level + 1]) - off
    side = spec.level_side(level)
    base_i, frac, okf = _lattice(x01, spec, level)
    rows = []
    for k in range(2 ** D):
        c = [base_i[:, d] + ((k >> d) & 1) for d in range(D)]
        if spec.level_is_hashed(level):
            row = _xor_hash(c, D) & (2 ** spec.log2_hashmap_size - 1)
        else:
            row = c[0]
            for d in range(1, D):
                row = row + c[d] * side ** d
            # only out-of-range inputs leave the level; their weight is 0
            row = row.clamp(0, size - 1)
        rows.append(off + row)
    return _corner_weights(frac, okf, D), torch.stack(rows)


def cell_corners(x01, spec: HashGridSpec, level: int):
    """Weights [2^D, N] and absolute cell-table rows [N] of one cell level
    (hashgrid.py:603-613): the row hashes the cell's base coordinate into
    the level's block of 2^log2_cell_size rows."""
    D = spec.input_dim
    ci = spec.cell_levels.index(level)
    base_i, frac, okf = _lattice(x01, spec, level)
    row = _xor_hash([base_i[:, d] for d in range(D)], D) \
        & (spec.cell_rows_per_level - 1)
    return _corner_weights(frac, okf, D), row + ci * spec.cell_rows_per_level


def hash_encode_cell_plain(cell_table, x01, spec: HashGridSpec):
    """The cell levels' encode [N, n_cell * C], in level order
    (hashgrid.py:332 `_cell_gather_sum`): sum_k w_k * row[k*C:(k+1)*C]."""
    x01 = x01.float()
    N, C, K = x01.shape[0], spec.level_dim, 2 ** spec.input_dim
    outs = []
    for level in spec.cell_levels:
        w, rows = cell_corners(x01, spec, level)
        vals = cell_table.index_select(0, rows).reshape(N, K, C)
        acc = torch.zeros(N, C, device=x01.device)
        for k in range(K):
            acc = acc + w[k, :, None] * vals[:, k]
        outs.append(acc)
    if not outs:
        return torch.zeros(N, 0, device=x01.device)
    return torch.cat(outs, dim=-1)


def hash_encode_baked_plain(baked, x01, spec: HashGridSpec):
    """The dense levels [N, Ld * C] from the baked vertex table
    [side_f^3, Ld * C] (hashgrid.py:635-646): the 8 corner rows of each
    point's cell on the finest dense level's lattice, weighted as that
    level's corners; zero for points outside [0, 1]^3."""
    x01 = x01.float()
    fine = spec.dense_levels[-1]
    w, rows = level_corners(x01, spec, fine)
    # the fine level's rows, clamped to the lattice: only points outside
    # the cube leave it, and their weight is 0
    rows = (rows - int(spec.offsets[fine])).clamp(
        0, spec.level_side(fine) ** 3 - 1)
    vals = baked.index_select(0, rows.reshape(-1)).reshape(
        8, x01.shape[0], baked.shape[1])
    acc = torch.zeros(x01.shape[0], baked.shape[1], device=x01.device)
    for k in range(8):
        acc = acc + w[k, :, None] * vals[k]
    return acc


def corner_level_plain(table, x01, spec: HashGridSpec, level: int):
    """One corner level's encode [N, C]: the weighted sum of its 2^D corner
    rows, in corner order."""
    w, rows = level_corners(x01, spec, level)
    N, C = x01.shape[0], spec.level_dim
    vals = table.index_select(0, rows.reshape(-1)).reshape(-1, N, C)
    acc = torch.zeros(N, C, device=x01.device)
    for k in range(w.shape[0]):
        acc = acc + w[k, :, None] * vals[k]
    return acc


def hash_encode_plain(table, x01, spec: HashGridSpec, cell_table=None,
                      baked=None):
    """[N, D] positions in [0, 1] -> [N, L * C]; zero rows for inputs
    outside [0, 1]^D (hashgrid.py:533-688, corner and cell levels; with
    `baked`, the dense levels from the baked vertex table)."""
    x01 = x01.float()
    C = spec.level_dim
    outs = [None] * spec.num_levels
    if baked is not None:
        dense = hash_encode_baked_plain(baked, x01, spec)
        for j, level in enumerate(spec.dense_levels):
            outs[level] = dense[:, j * C:(j + 1) * C]
    for level in (spec.corner_levels if baked is None
                  else spec.unbaked_levels):
        outs[level] = corner_level_plain(table, x01, spec, level)
    if spec.cell_levels:
        cells = hash_encode_cell_plain(cell_table, x01, spec)
        for i, level in enumerate(spec.cell_levels):
            outs[level] = cells[:, i * C:(i + 1) * C]
    return torch.cat(outs, dim=-1)


def hash_encode_bwd_plain(x01, g, spec: HashGridSpec):
    """Corner-table gradient [T, C] of `hash_encode` for the upstream
    gradient g [N, L * C]: g_table[row] += w * g per corner (index_add_),
    the scatter of hashgrid.py:284 `_corner_gather_sum_bwd` and of the
    packed dense gather's autodiff."""
    x01 = x01.float()
    C = spec.level_dim
    g = g.float().reshape(x01.shape[0], spec.num_levels, C)
    grad = torch.zeros(spec.table_size, C, device=x01.device)
    for level in spec.corner_levels:
        w, rows = level_corners(x01, spec, level)
        grad.index_add_(0, rows.reshape(-1),
                        (w[:, :, None] * g[None, :, level]).reshape(-1, C))
    return grad


def hash_encode_cell_bwd_plain(x01, g, spec: HashGridSpec):
    """Cell-table gradient [Tc, 2^D * C] for the upstream gradient
    g [N, L * C]: row[k*C:(k+1)*C] += w_k * g per cell level (the table
    part of hashgrid.py:362 `_cell_gather_sum_bwd`)."""
    x01 = x01.float()
    N, C = x01.shape[0], spec.level_dim
    g = g.float().reshape(N, spec.num_levels, C)
    grad = torch.zeros(spec.cell_table_size, spec.cell_row_width,
                       device=x01.device)
    for level in spec.cell_levels:
        w, rows = cell_corners(x01, spec, level)
        grad.index_add_(0, rows, (w.T[:, :, None] * g[:, None, level])
                        .reshape(N, -1))
    return grad


@functools.cache
def _levels(spec: HashGridSpec, cell: bool,
            baked: bool = False) -> kernels.HashLevels:
    """The corner levels (K1/K7, K12/K13; with `baked`, those a baked
    encode leaves to K1) or the cell levels (K10/K11) of `spec`, in their
    slots of an [N, L] row of level outputs."""
    levels = (spec.cell_levels if cell else
              spec.unbaked_levels if baked else spec.corner_levels)
    if spec.num_levels > kernels.MAX_LEVELS:
        raise ValueError(f"the hash kernels take at most {kernels.MAX_LEVELS}"
                         " levels")
    lv = kernels.HashLevels()
    lv.n_levels = len(levels)
    lv.out_levels = spec.num_levels
    lv.hash_mask = (spec.cell_rows_per_level if cell
                    else 2 ** spec.log2_hashmap_size) - 1
    offsets = spec.offsets
    for i, level in enumerate(levels):
        lv.level[i] = level
        lv.side[i] = spec.level_side(level)
        lv.hashed[i] = int(cell or spec.level_is_hashed(level))
        # rounded to f32 once from the float64 value, as JAX does when it
        # multiplies an f32 array by a Python float
        lv.scale[i] = float(np.float32(spec.level_scale(level)))
        if cell:
            lv.offset[i] = i * spec.cell_rows_per_level
            continue
        lv.offset[i] = int(offsets[level])
        size = int(offsets[level + 1] - offsets[level])
        if lv.hashed[i] and size != 2 ** spec.log2_hashmap_size:
            raise ValueError("hashed level size must be the power-of-two cap")
    return lv


def _check_k1(name, spec: HashGridSpec, x01, dims=(3,), **tensors):
    """CUDA, float32, contiguous, x01 [N, D]; `dims` are the input
    dimensions the kernel takes (K1/K7 3, K12/K13 2, the cell kernels 3)."""
    dev = kernels.check_cuda(name, x01=x01, **tensors)
    if spec.input_dim not in dims or spec.level_dim != 2:
        raise NotImplementedError(
            f"{name}: the kernel takes input_dim {dims} and level_dim 2, got "
            f"{spec.input_dim} and {spec.level_dim}")
    if x01.dtype != torch.float32 or \
            any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError(f"{name}: tensors must be float32")
    if spec.input_dim == 2 and spec.cell_levels:
        raise NotImplementedError("cell levels are 3-D only, as in the JAX "
                                  "package")
    if x01.ndim != 2 or x01.shape[1] != spec.input_dim:
        raise ValueError(f"x01 must be [N, {spec.input_dim}], got "
                         f"{tuple(x01.shape)}")
    return dev


def _check_table(table, spec: HashGridSpec):
    if tuple(table.shape) != (spec.table_size, 2):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({spec.table_size}, 2)")
    if table.data_ptr() % 8:
        raise ValueError("hash_encode: table rows must be 8-byte aligned")


def _check_g(g, x01, spec: HashGridSpec):
    if tuple(g.shape) != (x01.shape[0], spec.output_dim):
        raise ValueError(f"g must be [{x01.shape[0]}, {spec.output_dim}], "
                         f"got {tuple(g.shape)}")


def _check_cell_table(cell_table, spec: HashGridSpec):
    want = (spec.cell_table_size, spec.cell_row_width)
    if cell_table is None or tuple(cell_table.shape) != want:
        got = None if cell_table is None else tuple(cell_table.shape)
        raise ValueError(f"cell table shape {got} != {want}")
    if cell_table.data_ptr() % 16:
        raise ValueError("cell table rows must be 16-byte aligned")


def hash_encode_cell_fwd(cell_table, x01, spec: HashGridSpec, out):
    """The cell levels' encode into their slots of `out` [N, L * 2] (the
    other slots are left as they are): K10 on CUDA tensors (x01 and out
    need only a float's alignment), the plain version on CPU tensors."""
    n = x01.shape[0]
    if tuple(out.shape) != (n, spec.output_dim):
        raise ValueError(f"out must be [{n}, {spec.output_dim}]")
    if x01.device.type == "cpu" and cell_table.device.type == "cpu":
        cells = hash_encode_cell_plain(cell_table, x01, spec)
        for i, level in enumerate(spec.cell_levels):
            out[:, 2 * level:2 * level + 2] = cells[:, 2 * i:2 * i + 2]
        return out
    _check_k1("hash_encode_cell", spec, x01, cell_table=cell_table, out=out)
    _check_cell_table(cell_table, spec)
    with torch.cuda.device(x01.device):
        kernels.launch("pvd_hash_cell_fwd", x01.data_ptr(),
                       cell_table.data_ptr(), out.data_ptr(), n,
                       _levels(spec, True), kernels.stream_ptr(x01))
    hash_encode_cell_fwd.launches += 1
    return out


hash_encode_cell_fwd.launches = 0


def _count_corner_launch(counted, spec: HashGridSpec):
    """The corner kernels count on the wrapper `counted`: K1/K7 in
    `.launches`, K12/K13 (a 2-D grid, the background's) in
    `.launches_2d`."""
    if spec.input_dim == 2:
        counted.launches_2d += 1
    else:
        counted.launches += 1


def _check_baked(baked, spec: HashGridSpec):
    fine = spec.dense_levels[-1] if spec.dense_levels else None
    want = (None if fine is None else
            (spec.level_side(fine) ** 3, len(spec.dense_levels) * 2))
    if want is None or tuple(baked.shape) != want:
        raise ValueError(f"baked table shape {tuple(baked.shape)} != "
                         f"{want} (the spec's dense levels)")
    if baked.data_ptr() % 8:
        raise ValueError("baked table rows must be 8-byte aligned")


@functools.cache
def _baked_levels(spec: HashGridSpec) -> kernels.HashLevels:
    """K15's levels: entry j fills the slot of dense level j; entry 0
    carries the finest dense level's lattice (side, scale), which K15's
    corner setup reads."""
    if len(spec.dense_levels) > kernels.MAX_BAKED_LEVELS:
        raise ValueError(f"K15 takes at most {kernels.MAX_BAKED_LEVELS} "
                         "dense levels")
    lv = kernels.HashLevels()
    fine = spec.dense_levels[-1]
    lv.n_levels = len(spec.dense_levels)
    lv.out_levels = spec.num_levels
    lv.side[0] = spec.level_side(fine)
    lv.scale[0] = float(np.float32(spec.level_scale(fine)))
    for j, level in enumerate(spec.dense_levels):
        lv.level[j] = level
    return lv


def hash_encode_baked_fwd(baked, x01, spec: HashGridSpec, out):
    """The dense levels' encode from the baked vertex table into their
    slots of `out` [N, L * 2] (the other slots are left as they are): K15
    on CUDA tensors, the plain version on CPU tensors."""
    n = x01.shape[0]
    if tuple(out.shape) != (n, spec.output_dim):
        raise ValueError(f"out must be [{n}, {spec.output_dim}]")
    if x01.device.type == "cpu" and baked.device.type == "cpu":
        dense = hash_encode_baked_plain(baked, x01, spec)
        for j, level in enumerate(spec.dense_levels):
            out[:, 2 * level:2 * level + 2] = dense[:, 2 * j:2 * j + 2]
        return out
    _check_k1("hash_encode_baked", spec, x01, baked=baked, out=out)
    _check_baked(baked, spec)
    with torch.cuda.device(x01.device):
        kernels.launch("pvd_hash_baked_fwd", x01.data_ptr(),
                       baked.data_ptr(), out.data_ptr(), n,
                       _baked_levels(spec), kernels.stream_ptr(x01))
    hash_encode_baked_fwd.launches += 1
    return out


hash_encode_baked_fwd.launches = 0


def hash_encode_fwd(table, x01, spec: HashGridSpec, cell_table=None,
                    baked=None):
    """Forward encode, no autograd: K1 (corner levels; K12 for a 2-D grid)
    and K10 (cell levels) on CUDA tensors, the plain version on CPU
    tensors.  With `baked` (`build_baked_dense`'s vertex table) K15 fills
    the dense levels and K1 runs only on the other corner levels."""
    if spec.cell_levels and cell_table is None:
        raise ValueError("hash_encode: the spec has cell levels; pass "
                         "cell_table")
    if x01.device.type == "cpu" and table.device.type == "cpu":
        return hash_encode_plain(table, x01, spec, cell_table, baked)
    _check_k1("hash_encode", spec, x01, dims=(2, 3), table=table)
    _check_table(table, spec)
    n = x01.shape[0]
    out = torch.empty(n, spec.output_dim, device=x01.device)
    if baked is not None:
        hash_encode_baked_fwd(baked, x01, spec, out=out)
    if spec.corner_levels if baked is None else spec.unbaked_levels:
        entry = ("pvd_hash_encode2_fwd" if spec.input_dim == 2
                 else "pvd_hash_encode_fwd")
        with torch.cuda.device(x01.device):
            kernels.launch(entry, x01.data_ptr(), table.data_ptr(),
                           out.data_ptr(), n,
                           _levels(spec, False, baked is not None),
                           kernels.stream_ptr(x01))
        _count_corner_launch(hash_encode, spec)
    if spec.cell_levels:
        hash_encode_cell_fwd(cell_table, x01, spec, out=out)
    return out


@functools.cache
def _bake_axes(spec: HashGridSpec):
    """Per dense level j, the lattice base b [Ld, side_f] (int32) and
    fraction f [Ld, side_f] (float32) of each fine vertex coordinate on
    level j's lattice, computed in float64 on the host as JAX does
    (hashgrid.py:502-514): x01 = (v - 0.5) / scale_f, pos = x01 * scale_l
    + 0.5, b = clip(floor(pos), 0, side_l - 2), f = float32(pos - b), which
    extrapolates at the edges.  The finest level's row is b = v, f = 0."""
    fine = spec.dense_levels[-1]
    side_f = spec.level_side(fine)
    v = np.arange(side_f, dtype=np.float64)
    x01_axis = (v - 0.5) / spec.level_scale(fine)
    bs, fs = [], []
    for level in spec.dense_levels:
        pos = x01_axis * spec.level_scale(level) + 0.5
        b = np.clip(np.floor(pos).astype(np.int64), 0,
                    spec.level_side(level) - 2)
        if level == fine:
            b = v.astype(np.int64)
        bs.append(b)
        fs.append((pos - b).astype(np.float32) if level != fine
                  else np.zeros(side_f, np.float32))
    return np.stack(bs).astype(np.int32), np.stack(fs)


@functools.cache
def _bake_axes_on(spec: HashGridSpec, dev: torch.device):
    """`_bake_axes` on the device, copied there once."""
    bs, fs = _bake_axes(spec)
    return torch.from_numpy(bs).to(dev), torch.from_numpy(fs).to(dev)


def build_baked_dense_plain(table, spec: HashGridSpec):
    """The baked vertex table [side_f^3, Ld * C] of a frozen corner table
    (hashgrid.py:461-530, before its neighbourhood packing): the finest
    dense level's rows copied, each coarser dense level's trilinear feature
    at every fine vertex, the 8 corners summed in the order k = dx + 2 dy
    + 4 dz as acc + row * w, each product and sum rounded on its own (JAX
    builds it with eager ops: no FMA), w = (wx * wy) * wz."""
    fine = spec.dense_levels[-1]
    side_f = spec.level_side(fine)
    bs, fs = _bake_axes(spec)
    offsets = spec.offsets
    feats = []
    for j, level in enumerate(spec.dense_levels):
        off = int(offsets[level])
        if level == fine:
            feats.append(table[off:off + side_f ** 3])
            continue
        side_l = spec.level_side(level)
        sub = table[off:off + side_l ** 3]
        b = torch.from_numpy(bs[j]).to(table.device).long()
        f = torch.from_numpy(fs[j]).to(table.device)
        acc = torch.zeros(side_f ** 3, spec.level_dim, device=table.device)
        for k in range(8):
            dx, dy, dz = k & 1, (k >> 1) & 1, (k >> 2) & 1
            idx = ((b + dx)[None, None, :] + (b + dy)[None, :, None] * side_l
                   + (b + dz)[:, None, None] * side_l * side_l).reshape(-1)
            w = ((f if dx else 1.0 - f)[None, None, :]
                 * (f if dy else 1.0 - f)[None, :, None]
                 * (f if dz else 1.0 - f)[:, None, None]).reshape(-1, 1)
            acc = acc + sub[idx] * w
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def _bake_levels(spec: HashGridSpec) -> kernels.HashLevels:
    """K16's level list: entry j is dense level j's table block; the last
    entry, the finest level, is copied."""
    lv = kernels.HashLevels()
    lv.n_levels = len(spec.dense_levels)
    for j, level in enumerate(spec.dense_levels):
        lv.offset[j] = int(spec.offsets[level])
        lv.side[j] = spec.level_side(level)
    return lv


def build_baked_dense(table, spec: HashGridSpec):
    """The baked vertex table [side_f^3, Ld * 2] of a frozen corner table
    [T, 2]: K16 on a CUDA table, the plain version on a CPU one."""
    if not spec.dense_levels:
        raise ValueError("build_baked_dense: the spec has no dense level")
    if table.device.type == "cpu":
        return build_baked_dense_plain(table, spec)
    dev = kernels.check_cuda("build_baked_dense", table=table)
    if table.dtype != torch.float32:
        raise TypeError("build_baked_dense: the table must be float32")
    _check_table(table, spec)
    side_f = spec.level_side(spec.dense_levels[-1])
    b, f = _bake_axes_on(spec, dev)
    lv = _bake_levels(spec)
    baked = torch.empty(side_f ** 3, 2 * lv.n_levels, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_hash_bake", table.data_ptr(), b.data_ptr(),
                       f.data_ptr(), baked.data_ptr(), side_f, lv,
                       kernels.stream_ptr(table))
    build_baked_dense.launches += 1
    return baked


build_baked_dense.launches = 0


def hash_encode_bwd(x01, g, spec: HashGridSpec):
    """Corner-table gradient [T, 2] for the upstream gradient g [N, L * 2]:
    K7 (K13 for a 2-D grid) on CUDA tensors, the plain version on CPU
    tensors.  Both sum the contributions of a warp's points in one lattice
    cell before they add them."""
    if x01.device.type == "cpu" and g.device.type == "cpu":
        return hash_encode_bwd_plain(x01, g, spec)
    _check_k1("hash_encode_bwd", spec, x01, dims=(2, 3), g=g)
    _check_g(g, x01, spec)
    if spec.input_dim == 2 and spec.num_levels != 4:
        raise NotImplementedError("K13 is built for the background grid's 4 "
                                  "levels (bg_grid_spec)")
    if g.data_ptr() % 16:  # K7 and K13 read g's rows as float4s
        g = g.clone()
    grad = torch.zeros(spec.table_size, 2, device=x01.device)
    if spec.corner_levels:
        entry = ("pvd_hash_encode2_bwd" if spec.input_dim == 2
                 else "pvd_hash_encode_bwd")
        with torch.cuda.device(x01.device):
            kernels.launch(entry, x01.data_ptr(), g.data_ptr(),
                           grad.data_ptr(), x01.shape[0],
                           _levels(spec, False), kernels.stream_ptr(x01))
        _count_corner_launch(hash_encode_bwd, spec)
    return grad


hash_encode_bwd.launches = hash_encode_bwd.launches_2d = 0


def hash_encode_cell_bwd(x01, g, spec: HashGridSpec):
    """Cell-table gradient [Tc, 16] for the upstream gradient g [N, L * 2]:
    K11 on CUDA tensors, the plain version on CPU tensors.  Dense: AdamW
    updates every row, as optax does."""
    if x01.device.type == "cpu" and g.device.type == "cpu":
        return hash_encode_cell_bwd_plain(x01, g, spec)
    _check_k1("hash_encode_cell_bwd", spec, x01, g=g)
    _check_g(g, x01, spec)
    if g.data_ptr() % 8:  # K11 reads g's level slots as float2s
        g = g.clone()
    grad = torch.zeros(spec.cell_table_size, spec.cell_row_width,
                       device=x01.device)
    with torch.cuda.device(x01.device):
        kernels.launch("pvd_hash_cell_bwd", x01.data_ptr(), g.data_ptr(),
                       grad.data_ptr(), x01.shape[0],
                       _levels(spec, True), kernels.stream_ptr(x01))
    hash_encode_cell_bwd.launches += 1
    return grad


hash_encode_cell_bwd.launches = 0


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, cell_table, x01, spec):
        ctx.save_for_backward(x01)
        ctx.spec = spec
        return hash_encode_fwd(table, x01, spec, cell_table)

    @staticmethod
    def backward(ctx, g):
        (x01,) = ctx.saved_tensors
        g = g.contiguous()
        g_table = g_cell = None
        if ctx.needs_input_grad[0]:
            g_table = hash_encode_bwd(x01, g, ctx.spec)
        if ctx.needs_input_grad[1]:
            g_cell = hash_encode_cell_bwd(x01, g, ctx.spec)
        return g_table, g_cell, None, None


def hash_encode(table, x01, spec: HashGridSpec, cell_table=None,
                baked=None):
    """Hash encode [N, D] positions in [0, 1] -> [N, L * C],
    differentiable in `table` and `cell_table` (forward K1 + K10, backward
    K7 + K11 on CUDA tensors, K12 and K13 for a 2-D grid; the plain
    versions on CPU tensors).
    `cell_table` [n_cell * 2^16, 16] is needed when the spec has cell
    levels.  `baked`, a frozen table's `build_baked_dense`, takes the dense
    levels (K15) and has no gradient: grad mode must be off.  `x01` takes
    no gradient: it must not require one while grad mode is on."""
    if baked is not None and torch.is_grad_enabled():
        raise RuntimeError("hash_encode: a baked table is frozen and has no"
                           " gradient; encode under torch.no_grad()")
    if not torch.is_grad_enabled():
        return hash_encode_fwd(table, x01, spec, cell_table, baked)
    if x01.requires_grad:
        raise NotImplementedError(
            "hash_encode: no gradient into the positions (they come from "
            "the march); detach x01")
    if table.requires_grad or (cell_table is not None
                               and cell_table.requires_grad):
        return _HashEncode.apply(table, cell_table, x01, spec)
    return hash_encode_fwd(table, x01, spec, cell_table)


hash_encode.launches = hash_encode.launches_2d = 0
