"""Field-network interface over the four architectures (port of
pvd_tpu/models/api.py:42-137).

`field_forward` and `field_density` dispatch on `spec.model_type`: the
hash and MLP fields ignore `aabb` (they use the cubic bound), the VM and
plenoxel fields map positions through it.  Parameter paths are the port's
parameter names split at the dots (`planes.0`, `basis_mat`,
`color_net.1.weight`, `bg.encoder`): their first element names the same
part as the JAX package's pytree path.

The background sphere model (`bg_radius > 0`, any field) is `Background`:
a 2-D hash grid over the polar coordinates of the point where a ray leaves
the sphere (`ops/aabb.polar_from_ray`), concatenated after the ray
direction's SH encoding, through a bias-free MLP with a final sigmoid, in
float32 whatever the heads' dtype.  A field that has one holds it as its
`bg` submodule; `background_rgb` evaluates it on polar coordinates, and
`background_of_rays` behind rays, as the renderer does.
"""

from __future__ import annotations

import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.common import apply_mlp, make_mlp, mlp_dims
from pvd_tpu_torch.models.heads import FieldOut
from pvd_tpu_torch.ops.aabb import polar01_from_ray
from pvd_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode
from pvd_tpu_torch.ops.sh import sh_encode

# the fields whose queries map positions through the aabb
_AABB_FIELDS = ("vm", "tensors")


def field_forward(field, spec: ModelSpec, x, d, aabb,
                  want_color: bool = True) -> FieldOut:
    """x: [N, 3] in [-bound, bound]; d: [N, 3] unit directions."""
    if spec.model_type in _AABB_FIELDS:
        return field(x, d, aabb, want_color)
    return field(x, d, want_color)


def field_density(field, spec: ModelSpec, x, aabb):
    """Density-only query for occupancy-grid upkeep."""
    if spec.model_type in _AABB_FIELDS:
        return field.density(x, aabb)
    return field.density(x)


def param_group_label(spec: ModelSpec):
    """fn(path) -> 'main' | 'head_lr2' (api.py:63-76): only the VM field
    puts its color_net and basis_mat on the secondary learning rate."""

    def label(path) -> str:
        if spec.model_type == "vm" and path and \
                path[0] in ("color_net", "basis_mat"):
            return "head_lr2"
        return "main"

    return label


def trainable_label(spec: ModelSpec, distill_mode: str):
    """fn(path) -> bool (api.py:79-94): fix_mlp freezes the shared heads
    (sigma_net, color_net) and trains everything else."""

    def is_trainable(path) -> bool:
        if distill_mode != "fix_mlp":
            return True
        return not (path and path[0] in ("sigma_net", "color_net"))

    return is_trainable


def vm_density_l1(field):
    """L1 regularizer over the VM sigma planes and lines (api.py:97-99)."""
    return field.density_l1()


# ---- background sphere model (bg_radius > 0, api.py:102-137) -------------

def bg_grid_spec() -> HashGridSpec:
    """4 levels x 2 channels over [0, 1]^2, resolutions 16/81/407/2048:
    levels 0-2 dense, level 3 hashed into 2^19 rows (api.py:105-111)."""
    return HashGridSpec(input_dim=2, num_levels=4, level_dim=2,
                        base_resolution=16, log2_hashmap_size=19,
                        desired_resolution=2048)


class Background(nn.Module):
    """`encoder` [697,776, 2] hash table (U(-1e-4, 1e-4), as the JAX
    package's init) and `net`, bias-free Linear layers SH(d) ⊕ hash(polar)
    [dir_sh_degree^2 + 8] -> hidden_dim_bg -> 3 (api.py:114-124)."""

    def __init__(self, spec: ModelSpec, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.grid = bg_grid_spec()
        table = torch.empty(self.grid.table_size, self.grid.level_dim,
                            device=device)
        self.encoder = nn.Parameter(table.uniform_(-1e-4, 1e-4,
                                                   generator=generator))
        in_dim = self.grid.output_dim + spec.dir_sh_degree ** 2
        self.net = make_mlp(mlp_dims(in_dim, spec.hidden_dim_bg, 3,
                                     spec.num_layers_bg), device)

    def forward(self, polar01, d, spec: ModelSpec):
        """polar01 [N, 2], the polar coordinates mapped to [0, 1]; d [N, 3]
        -> [N, 3] sigmoid RGB."""
        h = hash_encode(self.encoder, polar01.contiguous(), self.grid)
        enc_d = sh_encode(d, spec.dir_sh_degree)
        return apply_mlp(self.net, torch.cat([enc_d, h], dim=-1),
                         final_activation="sigmoid")


def make_background(spec: ModelSpec, device, generator=None):
    """The field's background model when spec.bg_radius > 0, else None (the
    JAX package builds one for every field type, api.py:44-48)."""
    return Background(spec, device, generator) if spec.bg_radius > 0 \
        else None


def background_rgb(field, spec: ModelSpec, polar, d):
    """The field's background color [N, 3] for rays whose exit point on the
    background sphere has polar coordinates `polar` [N, 2] in [-1, 1]
    (api.py:127)."""
    return field.bg((polar.float() + 1.0) * 0.5, d.float(), spec)


def background_of_rays(field, spec: ModelSpec, rays_o, rays_d):
    """The field's background color [N, 3] behind rays [N, 3]: what the
    JAX package's render computes as background_rgb(polar_from_ray(o, d,
    bg_radius), d), with the encode's input rounded as that render's
    fusion rounds it (`ops/aabb.polar01_from_ray`)."""
    return field.bg(polar01_from_ray(rays_o, rays_d, spec.bg_radius),
                    rays_d.float(), spec)
