"""Occupancy-grid state and upkeep (port of pvd_tpu/render/occupancy.py).

Grids are row-major [CAS, H, H, H]; the bitfield is a flat bool
[CAS * H^3].  The TPU's supercell probe masks (`neighbor_masks`) and the
dilated bitfield are march-side layouts of the same bits: the CUDA march
(K2) reads `bitfield` directly, so neither is kept.

Random draws are arguments: `update_density_grid` takes the jitter (and, in
partial mode, the cells) as tensors, so a test can hand the JAX package's
draws to both.  `draw_occ_inputs` makes them from a `torch.Generator` as
the JAX package draws them (occupancy.py:259-296).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pvd_tpu_torch.config import RenderSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.ops.fma import fma32


@dataclasses.dataclass(frozen=True)
class OccupancyState:
    density_grid: torch.Tensor  # [CAS, H, H, H] f32; -1 marks untrained cells
    bitfield: torch.Tensor  # [CAS * H^3] bool, flat row-major
    mean_density: torch.Tensor  # scalar f32
    iter_density: int
    aabb_train: torch.Tensor  # [6]
    aabb_infer: torch.Tensor  # [6]

    def replace(self, **kw) -> "OccupancyState":
        return dataclasses.replace(self, **kw)


def init_occupancy_state(rspec: RenderSpec, device="cuda") -> OccupancyState:
    device = resolve_device(device)
    H, C, b = rspec.grid_size, rspec.cascades, rspec.bound
    aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32,
                        device=device)
    return OccupancyState(
        density_grid=torch.zeros(C, H, H, H, device=device),
        bitfield=torch.zeros(C * H * H * H, dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
        iter_density=0,
        aabb_train=aabb,
        aabb_infer=aabb.clone(),
    )


def set_bitfield(state: OccupancyState, bitfield) -> OccupancyState:
    H, C = state.density_grid.shape[1], state.density_grid.shape[0]
    if bitfield.shape != (C * H * H * H,):
        raise ValueError(f"bitfield has shape {tuple(bitfield.shape)}, state "
                         f"expects ({C}*{H}^3,) = ({C * H * H * H},)")
    return state.replace(bitfield=bitfield.to(torch.bool))


def grid_coords(H: int, device) -> torch.Tensor:
    """All cell coordinates [H^3, 3], row-major (x slowest)."""
    r = torch.arange(H, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def query_points(coords, cas: int, jitter, rspec: RenderSpec):
    """Jittered world positions of cells `coords` [M, 3] in cascade `cas`;
    jitter [M, 3] is uniform in [0, 1) (occupancy.py:259-264)."""
    H = rspec.grid_size
    bound = min(2.0 ** cas, rspec.bound)
    half = bound / H
    xyz = (2.0 * coords.float() / (H - 1) - 1.0) * (bound - half)
    return xyz + (jitter * 2.0 - 1.0) * half


def draw_occ_inputs(generator: torch.Generator, state: OccupancyState,
                    rspec: RenderSpec, full: bool):
    """Random inputs of one `update_density_grid` call, on the grid's
    device: (jitter, coords).

    full: jitter [CAS, H^3, 3] uniform in [0, 1), coords None.
    partial (occupancy.py:279-296): per cascade, H^3/4 uniform cells, then
    H^3/4 cells resampled from the occupied ones (density > 0) by inverse
    CDF, or the uniform cells again when none is occupied; jitter
    [CAS, H^3/2, 3] and coords [CAS, H^3/2, 3].
    """
    H, C = rspec.grid_size, rspec.cascades
    dev = state.density_grid.device
    if full:
        return torch.rand((C, H ** 3, 3), generator=generator,
                          device=dev), None
    n = H ** 3 // 4
    jitters, coords = [], []
    for cas in range(C):
        rand_coords = torch.randint(0, H, (n, 3), generator=generator,
                                    device=dev)
        cdf = torch.cumsum((state.density_grid[cas].reshape(-1) > 0).float(),
                           0)
        total = cdf[-1]
        u = torch.rand(n, generator=generator, device=dev) \
            * total.clamp_min(1.0)
        flat = torch.searchsorted(cdf, u, side="left").clamp(0, H ** 3 - 1)
        occ_coords = torch.stack([flat // (H * H), (flat // H) % H, flat % H],
                                 dim=-1)
        occ_coords = torch.where(total > 0, occ_coords, rand_coords)
        coords.append(torch.cat([rand_coords, occ_coords]))
        jitters.append(torch.rand((2 * n, 3), generator=generator,
                                  device=dev))
    return torch.stack(jitters), torch.stack(coords)


def mark_untrained_grid(state: OccupancyState, poses, intrinsics,
                        rspec: RenderSpec, chunk: int = 64) -> OccupancyState:
    """Mark cells seen by no training camera as -1 (occupancy.py:320-365).

    poses [B, 4, 4] c2w (numpy or tensor); intrinsics (fx, fy, cx, cy).  A
    cell counts as covered when its center lies in front of a camera and
    inside its pinhole frustum, with a margin of one voxel.  The rotation
    and the frustum test use XLA:CPU's FMA contractions (ops/fma.py), so the
    marks equal the JAX package's.
    """
    H, C = rspec.grid_size, rspec.cascades
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    grid = state.density_grid
    dev = grid.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    world = 2.0 * grid_coords(H, dev).float() / (H - 1) - 1.0  # [M, 3]
    counts = []
    for cas in range(C):
        bound = min(2.0 ** cas, rspec.bound)
        half = bound / H
        pts = world * (bound - half)
        covered = torch.zeros(H ** 3, dtype=torch.int32, device=dev)
        for head in range(0, poses.shape[0], chunk):
            p = poses[head:head + chunk]
            rel = pts[None] - p[:, None, :3, 3]  # [b, M, 3]
            rot = p[:, None, :3, :3]  # [b, 1, 3, 3]
            # rel @ R, the k-sum as XLA:CPU's FMA chain
            cam = fma32(rel[..., 2:3], rot[..., 2, :],
                        fma32(rel[..., 1:2], rot[..., 1, :],
                              rel[..., 0:1] * rot[..., 0, :]))
            mz = cam[..., 2] > 0
            mx = cam[..., 0].abs() < fma32(cx / fx, cam[..., 2], half * 2)
            my = cam[..., 1].abs() < fma32(cy / fy, cam[..., 2], half * 2)
            covered += (mz & mx & my).sum(0, dtype=torch.int32)
        counts.append(covered.reshape(H, H, H))
    count = torch.stack(counts)
    return state.replace(density_grid=torch.where(count == 0, -1.0, grid))


def update_density_grid(
    state: OccupancyState,
    density_fn: Callable,
    rspec: RenderSpec,
    full: bool,
    jitter: torch.Tensor,
    coords: Optional[torch.Tensor] = None,
    decay: float = 0.95,
) -> OccupancyState:
    """One occupancy update (occupancy.py:241-317).

    density_fn(x [M, 3]) -> sigma [M].
    full=True queries every cell of every cascade: jitter [CAS, H^3, 3].
    full=False queries `coords` [CAS, M, 3] (the JAX package draws H^3/4
    uniform cells plus H^3/4 resampled occupied ones): jitter [CAS, M, 3];
    repeated cells keep their maximum (scatter-max).
    """
    H, C = rspec.grid_size, rspec.cascades
    grid = state.density_grid
    tmp = -torch.ones_like(grid)
    if full:
        all_coords = grid_coords(H, grid.device)
        for cas in range(C):
            sig = density_fn(query_points(all_coords, cas, jitter[cas],
                                          rspec)) * rspec.density_scale
            tmp[cas] = sig.reshape(H, H, H)
    else:
        if coords is None:
            raise ValueError("partial update needs the cells to query")
        for cas in range(C):
            c = coords[cas].long()
            sig = density_fn(query_points(c, cas, jitter[cas], rspec)) \
                * rspec.density_scale
            flat = (c[:, 0] * H + c[:, 1]) * H + c[:, 2]
            tmp[cas] = tmp[cas].reshape(-1).scatter_reduce(
                0, flat, sig.float(), reduce="amax").reshape(H, H, H)

    # EMA-max where both old and new are valid (occupancy.py:302-304)
    valid = (grid >= 0) & (tmp >= 0)
    new_grid = torch.where(valid, torch.maximum(grid * decay, tmp), grid)
    mean_density = new_grid.clamp_min(0.0).mean()
    thresh = torch.clamp(mean_density, max=rspec.density_thresh)
    bitfield = (new_grid > thresh).reshape(-1)
    return state.replace(
        density_grid=new_grid,
        bitfield=bitfield,
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
    )
