"""Classic NeRF MLP field (port of pvd_tpu/models/mlp_field.py:26-91).

A PE(pe_multires) frequency encoding of the position feeds
`nerf_layer_num` Linear layers of width `nerf_layer_wide`, with biases,
ReLU between them; after layer `skip` the encoded input is concatenated in
front of the hidden state, so layer skip + 1 is wider.  The last layer
emits the hash encoder's width (28 at the defaults) into the same shared
`sigma_net` / `color_net` heads (`models/heads.py`), which is what lets an
MLP field distill into or from any other.  Positions are not normalized
(the aabb is unused, as in the JAX package).  The layers run in
`compute_dtype` (bf16 by default: the input encoding, weights and biases
cast, each product then its bias added as the JAX package adds them), and
the output is float32.  With `bg_radius` > 0 the field owns a background
model, `bg` (`models/api.Background`).
"""

from __future__ import annotations

import torch
from torch import nn

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.models.api import make_background
from pvd_tpu_torch.models.common import make_mlp, mlp_dims
from pvd_tpu_torch.models.heads import (FieldOut, compute_dtype,
                                        shared_density, shared_sigma_color)
from pvd_tpu_torch.ops.freq import freq_encode, freq_output_dim


def pe_dim(spec: ModelSpec) -> int:
    return freq_output_dim(3, spec.pe_multires)


def encoder_out_dim(spec: ModelSpec) -> int:
    """The nerf MLP emits the width the hash encoder would."""
    return spec.hash_num_levels * spec.hash_level_dim


def layer_dims(spec: ModelSpec) -> list:
    """(in, out) of each nerf_mlp layer (mlp_field.py:34-46)."""
    in_dim, W, n = pe_dim(spec), spec.nerf_layer_wide, spec.nerf_layer_num
    dims = [(in_dim, W)]
    for i in range(n - 2):
        dims.append((W + in_dim if i == spec.skip else W, W))
    return dims + [(W, encoder_out_dim(spec))]


class MLPField(nn.Module):
    """nerf_mlp (Linear layers with biases) + sigma_net + color_net (+ the
    background model `bg` when bg_radius > 0).

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  Initial values follow the JAX package's init (weights and
    biases uniform with bound 1/sqrt(fan_in), torch's Linear default),
    drawn from `generator`.
    """

    def __init__(self, spec: ModelSpec, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if spec.model_type != "mlp":
            raise ValueError("MLPField needs model_type='mlp'")
        device = resolve_device(device)
        self.spec = spec
        layers = []
        for d_in, d_out in layer_dims(spec):
            lin = nn.Linear(d_in, d_out, bias=True, device=device)
            bound = 1.0 / d_in ** 0.5
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)
            layers.append(lin)
        self.nerf_mlp = nn.ModuleList(layers)
        self.sigma_net = make_mlp(
            mlp_dims(encoder_out_dim(spec), spec.hidden_dim,
                     1 + spec.geo_feat_dim, spec.num_layers), device)
        self.color_net = make_mlp(
            mlp_dims(spec.dir_sh_degree ** 2 + spec.geo_feat_dim,
                     spec.hidden_dim_color, 3, spec.num_layers_color),
            device)
        self.bg = make_background(spec, device, generator)

    def encode(self, x):
        """x [N, 3] -> the nerf MLP's output [N, encoder_out_dim], float32
        (mlp_field.py:70-80)."""
        cdt = compute_dtype(self.spec)
        pe = freq_encode(x.float(), self.spec.pe_multires).to(cdt)
        h = pe
        last = len(self.nerf_mlp) - 1
        for i, lin in enumerate(self.nerf_mlp):
            h = torch.nn.functional.linear(h, lin.weight.to(cdt)) \
                + lin.bias.to(cdt)
            if i != last:
                h = torch.relu(h)
            if i == self.spec.skip:
                h = torch.cat([pe, h], dim=-1)
        return h.float()

    def forward(self, x, d, want_color: bool = True) -> FieldOut:
        """x: [N, 3] positions; d: [N, 3] unit directions."""
        return shared_sigma_color(self, self.spec, self.encode(x), d,
                                  want_color)

    def density(self, x):
        return shared_density(self, self.spec, self.encode(x))
