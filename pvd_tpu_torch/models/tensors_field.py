"""Plenoxels field (port of pvd_tpu/models/tensors_field.py:24-84).

One dense volume `volume` [D, H, W, 1 + 3 deg^2] (channels minor, the
layout of the JAX package; the reference's is [1, C, D, H, W]) queried by
trilinear interpolation (`ops/grid_sample.grid_sample_3d`) at positions
normalized by the aabb.  Channel 0 is the sigma logit; the other channels
are per-color SH coefficients, dotted with the SH encoding (degree
`plenoxel_degree`) of the view direction and passed through a sigmoid.
There is no MLP, and no separable feature: `fea_sc` is None, which is why
distillation skips stage 1 whenever either side is a plenoxel field.
`forward` clips the sigma logit; `density` does not (the reference clips
and then overwrites with the unclipped logit, network.py:470-476).  With
`bg_radius` > 0 the field owns a background model, `bg`
(`models/api.Background`), whose direction encoder then has the plenoxel
degree.  `upsample_params` resizes the volume trilinearly
(align_corners=True) for a coarse-to-fine schedule
(tensors_field.py:76-99).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import make_background
from pvd_tpu_torch.models.heads import FieldOut
from pvd_tpu_torch.models.vm_field import linear_resize_1d, linear_resize_2d
from pvd_tpu_torch.ops.activation import clip, trunc_exp
from pvd_tpu_torch.ops.grid_sample import grid_sample_3d
from pvd_tpu_torch.ops.sh import sh_encode


def normalize(x, aabb):
    """World positions -> [-1, 1] over the aabb (tensors_field.py:40-41)."""
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


class TensorsField(nn.Module):
    """The dense SH volume (+ the background model `bg` when bg_radius >
    0).  `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  The volume's initial values are normal with scale 0.02
    (tensors_field.py:24-37), drawn from `generator`."""

    def __init__(self, spec: ModelSpec, device="cuda",
                 generator: torch.Generator | None = None,
                 init_scale: float = 0.02):
        super().__init__()
        if spec.model_type != "tensors":
            raise ValueError("TensorsField needs model_type='tensors'")
        device = resolve_device(device)
        self.spec = spec
        vol = torch.empty(*spec.plenoxel_res, spec.plenoxel_fea_dim,
                          device=device)
        self.volume = nn.Parameter(vol.normal_(generator=generator)
                                   * init_scale)
        self.bg = make_background(spec, device, generator)

    def query(self, x, aabb):
        """The volume's channels [N, C] at world positions x [N, 3]."""
        return grid_sample_3d(self.volume, normalize(x, aabb))

    def forward(self, x, d, aabb, want_color: bool = True) -> FieldOut:
        """x: [N, 3] world positions; d: [N, 3] unit directions; aabb [6].
        The color is computed whatever `want_color` says, as the JAX
        package computes it (tensors_field.py:50-55)."""
        spec = self.spec
        h = self.query(x, aabb)
        s = clip(h[..., 0], spec.sigma_clip_min, spec.sigma_clip_max)
        deg2 = spec.plenoxel_degree ** 2
        sh_coef = h[..., 1:].reshape(-1, 3, deg2)
        enc_d = sh_encode(d, spec.plenoxel_degree)[:, None, :]
        rgb = torch.sigmoid((sh_coef * enc_d).sum(-1))
        return FieldOut(trunc_exp(s), rgb, s, None)

    def density(self, x, aabb):
        """sigma [N] from the UNCLIPPED logit (tensors_field.py:58-63)."""
        return trunc_exp(self.query(x, aabb)[..., 0])

    @torch.no_grad()
    def edit_erase_region(self, region=((None, None), (160, None),
                                        (None, 128)),
                          value: float = -100.0):
        """The enable_edit_plenoxel demo (tensors_field.py:66-73): write
        `value` into the sigma logits of a (D, H, W) region, in place; the
        default is the reference's region (network.py:313-316, the lego's
        bucket)."""
        (d0, d1), (h0, h1), (w0, w1) = region
        self.volume[d0:d1, h0:h1, w0:w1, 0] = value
        return self


@torch.no_grad()
def upsample_params(field: TensorsField, resolution) -> TensorsField:
    """Resize the volume separably and linearly (align_corners=True) to
    `resolution` (D, H, W) (tensors_field.py:76-99), in place: a new
    Parameter, and `field.spec.plenoxel_res` set to it.  The JAX package
    resizes (D, H), then (W, D * H) with the second axis unchanged; the
    port resizes W alone, which gives the same sums.  Returns the
    field."""
    vol = field.volume
    D, H, W, C = vol.shape
    nD, nH, nW = (int(r) for r in resolution)
    v = linear_resize_2d(vol.reshape(D, H, W * C), (nD, nH))
    v = v.reshape(nD, nH, W, C).permute(2, 0, 1, 3).reshape(W, -1)
    v = linear_resize_1d(v, nW).reshape(nW, nD, nH, C).permute(1, 2, 0, 3)
    field.volume = nn.Parameter(v.contiguous())
    field.spec = dataclasses.replace(field.spec, plenoxel_res=(nD, nH, nW))
    return field
