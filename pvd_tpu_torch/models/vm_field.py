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
"""

from __future__ import annotations

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
