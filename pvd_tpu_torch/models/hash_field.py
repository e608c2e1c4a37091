"""INGP hash-grid field (port of pvd_tpu/models/hash_field.py:18-126).

Encoder: 14 levels x 2 channels, base 16, desired resolution 2048*bound,
2^19-row table -> 28-d encoding into the shared heads.  Positions map to
[0, 1] through the cubic bound; the aabb is ignored, as in the JAX package.
The field trains: `encoder` is a parameter, and `hash_encode` sends it a
gradient (kernel K7 on the GPU) whenever grad mode is on.  The gradient is
dense, as the JAX package's is, so AdamW updates all of its rows every
step.
"""

from __future__ import annotations

import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.common import make_mlp, mlp_dims
from pvd_tpu_torch.models.heads import (FieldOut, shared_density,
                                        shared_sigma_color)
from pvd_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode


def grid_spec(spec: ModelSpec) -> HashGridSpec:
    return HashGridSpec(
        input_dim=3,
        num_levels=spec.hash_num_levels,
        level_dim=spec.hash_level_dim,
        base_resolution=spec.hash_base_res,
        log2_hashmap_size=spec.hash_log2_size,
        desired_resolution=int(spec.hash_desired_res * spec.bound),
    )


class HashField(nn.Module):
    """Hash table [T, 2] + sigma_net + color_net.

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  Initial values follow the JAX package's init (table
    U(-1e-4, 1e-4), Linear default init), drawn from `generator`.
    """

    def __init__(self, spec: ModelSpec, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if spec.model_type != "hash":
            raise ValueError("HashField needs model_type='hash'")
        device = resolve_device(device)
        self.spec = spec
        self.grid = grid_spec(spec)
        table = torch.empty(self.grid.table_size, self.grid.level_dim,
                            device=device)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.encoder = nn.Parameter(table)
        self.sigma_net = make_mlp(
            mlp_dims(self.grid.output_dim, spec.hidden_dim,
                     1 + spec.geo_feat_dim, spec.num_layers), device)
        self.color_net = make_mlp(
            mlp_dims(spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                     spec.hidden_dim_color, 3, spec.num_layers_color),
            device)

    def encode(self, x):
        x01 = (x + self.spec.bound) / (2.0 * self.spec.bound)
        return hash_encode(self.encoder, x01, self.grid)

    def forward(self, x, d, want_color: bool = True) -> FieldOut:
        """x: [N, 3] in [-bound, bound]; d: [N, 3] unit directions."""
        return shared_sigma_color(self, self.spec, self.encode(x), d,
                                  want_color)

    def density(self, x):
        return shared_density(self, self.spec, self.encode(x))
