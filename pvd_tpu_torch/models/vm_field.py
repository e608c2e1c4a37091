"""TensoRF-VM field (port of pvd_tpu/models/vm_field.py:41-292).

Low-rank vector-matrix factorization: for each branch i, a plane over axes
MAT_IDS[i] stored [res[m1], res[m0], R] (x fastest) and a line over axis
VEC_IDS[i] stored [res[v], R], for sigma (R = 16) and color (R = 48); a
bias-free basis matrix [3 * 48, 15] and the shared color_net.

The module holds each branch's sigma and color tables concatenated along
the channel axis (`planes[i]` [H, W, Rs + Rc], `lines[i]` [L, Rs + Rc]), so
one plane x line sample (`ops/vm_sample.py`, kernels K4/K5) serves both, as
the JAX package's `_joint_feats` fuses them; channels [:Rs] are the sigma
factors.  AdamW acts elementwise, so the concatenation changes no update.

Positions are normalized by the aabb and carry no gradient.  With
`bg_radius` > 0 the field owns a background model, `bg`
(`models/api.Background`).

Resizing (vm_field.py:298-386): `shrink_params` crops every plane and line
to an occupied sub-box of the aabb and `upsample_params` resizes them
linearly (align_corners=True) to a per-axis resolution.  Both replace the
tables with new contiguous Parameters under the same names, on the
field's device, so the caller rebuilds the optimizer state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import make_background
from pvd_tpu_torch.models.common import apply_mlp, make_mlp, mlp_dims
from pvd_tpu_torch.models.heads import FieldOut, compute_dtype
from pvd_tpu_torch.ops.activation import clip, trunc_exp
from pvd_tpu_torch.ops.sh import sh_encode
from pvd_tpu_torch.ops.vm_sample import MAT_IDS, VEC_IDS, vm_sample


def normalize(x, aabb):
    """World positions -> [-1, 1] over the aabb (vm_field.py:72-73)."""
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


class VMField(nn.Module):
    """VM planes and lines + basis matrix + color_net (+ the background
    model `bg` when bg_radius > 0).

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  Initial values follow the JAX package's init: planes and lines
    normal with scale 0.1, basis and color_net uniform with bound
    1/sqrt(fan_in), drawn from `generator`.
    """

    def __init__(self, spec: ModelSpec, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if spec.model_type != "vm":
            raise ValueError("VMField needs model_type='vm'")
        device = resolve_device(device)
        self.spec = spec
        res = spec.vm_resolution
        R = spec.vm_sigma_rank + spec.vm_color_rank

        def normal(*shape):
            t = torch.empty(*shape, device=device)
            return nn.Parameter(t.normal_(generator=generator) * 0.1)

        self.planes = nn.ParameterList(
            normal(res[m1], res[m0], R) for m0, m1 in MAT_IDS)
        self.lines = nn.ParameterList(normal(res[v], R) for v in VEC_IDS)
        n_in = 3 * spec.vm_color_rank
        basis = torch.empty(n_in, spec.geo_feat_dim, device=device)
        bound = 1.0 / n_in ** 0.5
        self.basis_mat = nn.Parameter(
            basis.uniform_(-bound, bound, generator=generator))
        self.color_net = make_mlp(
            mlp_dims(spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                     spec.hidden_dim_color, 3, spec.num_layers_color),
            device)
        self.bg = make_background(spec, device, generator)

    def _projection(self):
        """[3, R, 1 + geo]: sigma ranks sum into channel 0, color ranks go
        through the branch's slice of the basis (vm_field.py:245-259)."""
        Rs, Rc = self.spec.vm_sigma_rank, self.spec.vm_color_rank
        basis = self.basis_mat
        geo = basis.shape[1]
        top = torch.cat([basis.new_ones(Rs, 1), basis.new_zeros(Rs, geo)], 1)
        return torch.stack([
            torch.cat([top, torch.cat([basis.new_zeros(Rc, 1),
                                       basis[i * Rc:(i + 1) * Rc]], 1)], 0)
            for i in range(3)])

    def features(self, x, aabb):
        """Raw (sigma [N], color feature [N, geo]) before clipping."""
        prod = vm_sample(list(self.planes), list(self.lines),
                         normalize(x, aabb))
        sc = torch.bmm(prod, self._projection())  # [3, N, 1 + geo], f32
        sc = sc[0] + sc[1] + sc[2]
        return sc[:, 0], sc[:, 1:]

    def forward(self, x, d, aabb, want_color: bool = True) -> FieldOut:
        """x: [N, 3] world positions; d: [N, 3] unit directions; aabb [6].
        Every channel of sigma and color is clipped (vm_field.py:266-267)."""
        spec = self.spec
        s_raw, c_raw = self.features(x, aabb)
        s = clip(s_raw, spec.sigma_clip_min, spec.sigma_clip_max)
        c = clip(c_raw, spec.sigma_clip_min, spec.sigma_clip_max)
        fea_sc = torch.cat([s[:, None], c], dim=-1)
        sigma = trunc_exp(s)
        if not want_color:
            return FieldOut(sigma, None, s, fea_sc)
        enc_d = sh_encode(d, spec.dir_sh_degree)
        rgb = apply_mlp(self.color_net,
                        torch.cat([enc_d, c], dim=-1).to(compute_dtype(spec)),
                        final_activation="sigmoid").float()
        return FieldOut(sigma, rgb, s, fea_sc)

    def density(self, x, aabb):
        """sigma [N] from the sigma factors only (vm_field.py:281-284)."""
        Rs = self.spec.vm_sigma_rank
        prod = vm_sample(list(self.planes), list(self.lines),
                         normalize(x, aabb))
        s = prod[:, :, :Rs].sum(-1)
        s = s[0] + s[1] + s[2]
        return trunc_exp(clip(s, self.spec.sigma_clip_min,
                              self.spec.sigma_clip_max))

    def density_l1(self):
        """Mean |.| over the sigma planes and lines (vm_field.py:287-292):
        means over the sigma channels, with the JAX element counts."""
        Rs = self.spec.vm_sigma_rank
        loss = 0.0
        for m, v in zip(self.planes, self.lines):
            loss = loss + m[..., :Rs].abs().mean() + v[..., :Rs].abs().mean()
        return loss


def _axis_positions(n_old: int, n_new: int):
    """(fraction, lower index) of each of n_new align_corners=True sample
    positions over n_old, in float64 (vm_field.py:304-309)."""
    if n_new == 1:
        return np.zeros(1), np.zeros(1, np.int64)
    p = np.arange(n_new) * (n_old - 1) / (n_new - 1)
    i0 = np.clip(np.floor(p).astype(np.int64), 0, n_old - 1)
    return p - i0, i0


def linear_resize_2d(t: torch.Tensor, new_hw) -> torch.Tensor:
    """Bilinear align_corners=True resize of t [H, W, R] to [nh, nw, R],
    in float32 on t's device: the JAX package's corner indices and its
    term order a (1 - wy) (1 - wx) + b (1 - wy) wx + c wy (1 - wx) +
    d wy wx (vm_field.py:298-321), with the weights and their complements
    rounded from float64 (that function sums in float64 and rounds once,
    so the two agree to a few float32 ulps of max |t|)."""
    H, W = t.shape[0], t.shape[1]
    nh, nw = int(new_hw[0]), int(new_hw[1])
    fy, y0 = _axis_positions(H, nh)
    fx, x0 = _axis_positions(W, nw)
    y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)

    def ids(a):
        return torch.as_tensor(a, device=t.device)

    def wts(a, shape):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=t.device).reshape(shape)

    top, bot = t[ids(y0)], t[ids(y1)]
    a, b = top[:, ids(x0)], top[:, ids(x1)]
    c, d = bot[:, ids(x0)], bot[:, ids(x1)]
    wy, vy = wts(fy, (-1, 1, 1)), wts(1.0 - fy, (-1, 1, 1))
    wx, vx = wts(fx, (1, -1, 1)), wts(1.0 - fx, (1, -1, 1))
    return a * vy * vx + b * vy * wx + c * wy * vx + d * wy * wx


def linear_resize_1d(t: torch.Tensor, new_l: int) -> torch.Tensor:
    """Linear align_corners=True resize of t [L, R] to [new_l, R]."""
    return linear_resize_2d(t[:, None, :], (new_l, 1))[:, 0, :]


def _set_tables(field: VMField, planes, lines, resolution):
    field.planes = nn.ParameterList(nn.Parameter(p.contiguous())
                                    for p in planes)
    field.lines = nn.ParameterList(nn.Parameter(v.contiguous())
                                   for v in lines)
    field.spec = dataclasses.replace(
        field.spec, vm_resolution=tuple(int(r) for r in resolution))


@torch.no_grad()
def upsample_params(field: VMField, resolution) -> VMField:
    """Resize every plane and line of `field` linearly to `resolution`
    (X, Y, Z) (vm_field.py:330-360), in place: new Parameters, and
    `field.spec.vm_resolution` set to it.  Returns the field."""
    planes = [linear_resize_2d(p, (resolution[m1], resolution[m0]))
              for p, (m0, m1) in zip(field.planes, MAT_IDS)]
    lines = [linear_resize_1d(v, resolution[i])
             for v, i in zip(field.lines, VEC_IDS)]
    _set_tables(field, planes, lines, resolution)
    return field


@torch.no_grad()
def shrink_params(field: VMField, aabb: np.ndarray, new_aabb: np.ndarray,
                  resolution):
    """Crop every plane and line of `field` to the voxels of the sub-box
    `new_aabb` of `aabb` ([6] numpy each; the tables span `aabb` at
    `resolution`), in place (vm_field.py:363-386): new Parameters, and
    `field.spec.vm_resolution` set to br - tl.  Returns (tl, br), the
    integer crop bounds per axis."""
    reso = np.asarray(resolution, np.int64)
    units = (aabb[3:] - aabb[:3]) / reso
    tl = np.clip(np.round((new_aabb[:3] - aabb[:3]) / units).astype(np.int64),
                 0, None)
    br = np.minimum(np.round((new_aabb[3:] - aabb[:3]) / units)
                    .astype(np.int64), reso)
    planes = [p[tl[m1]:br[m1], tl[m0]:br[m0]].clone()
              for p, (m0, m1) in zip(field.planes, MAT_IDS)]
    lines = [v[tl[i]:br[i]].clone() for v, i in zip(field.lines, VEC_IDS)]
    _set_tables(field, planes, lines, br - tl)
    return tl, br
