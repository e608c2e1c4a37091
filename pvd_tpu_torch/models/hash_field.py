"""INGP hash-grid field (port of pvd_tpu/models/hash_field.py:18-126).

Encoder: 14 levels x 2 channels, base 16, desired resolution 2048*bound,
2^19-row table -> 28-d encoding into the shared heads.  Positions map to
[0, 1] through the cubic bound; the aabb is ignored, as in the JAX package.
With `hash_cell_levels` > 0 the finest hashed levels are cell-packed
(hash_field.py:31-56): the field then has a second table, `encoder_cell`
[n_cell * 2^16, 16], and the corner table `encoder` holds only the other
levels.  The field trains: the tables are parameters, and `hash_encode`
sends each a gradient (kernels K7 and K11 on the GPU) whenever grad mode is
on.  The gradients are dense, as the JAX package's are, so AdamW updates
all of their rows every step.  With `bg_radius` > 0 the field owns a
background model, `bg` (`models/api.Background`).

A frozen field with `hash_bake_dense` may be baked (`bake`, the port of
hash_field.py:59-84 attach_packed): its dense levels are evaluated once
onto the finest dense level's lattice (`ops/hashgrid.build_baked_dense`,
kernel K16) into the buffer `baked`, and `encode` reads them from there
(kernel K15).  The buffer is not a parameter and never reaches a
checkpoint (`params.tree_from_field` reads parameters only), as the JAX
package's checkpoints drop its '_baked' table; encoding a baked field in
grad mode raises.
"""

from __future__ import annotations

import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import make_background
from pvd_tpu_torch.models.common import make_mlp, mlp_dims
from pvd_tpu_torch.models.heads import (FieldOut, shared_density,
                                        shared_sigma_color)
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, build_baked_dense,
                                        hash_encode)


def grid_spec(spec: ModelSpec) -> HashGridSpec:
    return HashGridSpec(
        input_dim=3,
        num_levels=spec.hash_num_levels,
        level_dim=spec.hash_level_dim,
        base_resolution=spec.hash_base_res,
        log2_hashmap_size=spec.hash_log2_size,
        desired_resolution=int(spec.hash_desired_res * spec.bound),
        n_cell_levels=spec.hash_cell_levels,
    )


class HashField(nn.Module):
    """Hash table [T, 2] (+ cell table [Tc, 16] in cell mode) + sigma_net
    + color_net (+ the background model `bg` when bg_radius > 0).

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  Initial values follow the JAX package's init (tables
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
        self.encoder_cell = None
        if self.grid.cell_table_size:
            cell = torch.empty(self.grid.cell_table_size,
                               self.grid.cell_row_width, device=device)
            cell.uniform_(-1e-4, 1e-4, generator=generator)
            self.encoder_cell = nn.Parameter(cell)
        self.sigma_net = make_mlp(
            mlp_dims(self.grid.output_dim, spec.hidden_dim,
                     1 + spec.geo_feat_dim, spec.num_layers), device)
        self.color_net = make_mlp(
            mlp_dims(spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                     spec.hidden_dim_color, 3, spec.num_layers_color),
            device)
        self.bg = make_background(spec, device, generator)
        self.register_buffer("baked", None, persistent=False)

    @torch.no_grad()
    def bake(self):
        """Bake the frozen table's dense levels when the spec asks for it
        (`hash_bake_dense`) and the grid has dense levels, as attach_packed
        does; else leave the field as it is."""
        if self.spec.hash_bake_dense and self.grid.dense_levels:
            self.baked = build_baked_dense(self.encoder.detach(), self.grid)
        return self

    def encode(self, x):
        x01 = (x + self.spec.bound) / (2.0 * self.spec.bound)
        return hash_encode(self.encoder, x01, self.grid, self.encoder_cell,
                           self.baked)

    def forward(self, x, d, want_color: bool = True) -> FieldOut:
        """x: [N, 3] in [-bound, bound]; d: [N, 3] unit directions."""
        return shared_sigma_color(self, self.spec, self.encode(x), d,
                                  want_color)

    def density(self, x):
        return shared_density(self, self.spec, self.encode(x))
