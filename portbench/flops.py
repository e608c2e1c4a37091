"""Model FLOPs per valid sample, counted from the configuration's widths
(the same work counted whatever implements it): the heads' GEMMs (2 per
multiply-add), the encodings' interpolation and the VM projection.  A
trained field costs its forward plus twice that for the backward; a frozen
one and a render the forward alone.  Padded slots are not counted."""

from __future__ import annotations


def _mlp(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def sigma_net_dims(model: dict) -> list:
    enc = model["hash_num_levels"] * model["hash_level_dim"]
    return [enc] + [model["hidden_dim"]] * (model["num_layers"] - 1) + [
        1 + model["geo_feat_dim"]]


def color_net_dims(model: dict) -> list:
    return [model["sh_degree"] ** 2 + model["geo_feat_dim"]] + [
        model["hidden_dim_color"]] * (model["num_layers_color"] - 1) + [3]


def hash_interp(model: dict) -> int:
    """8 corners x level_dim multiply-adds a level."""
    return 2 * 8 * model["hash_level_dim"] * model["hash_num_levels"]


def vm_interp(model: dict) -> int:
    """Per branch and channel: 4 plane taps, 2 line taps, one product."""
    R = model["vm_sigma_rank"] + model["vm_color_rank"]
    return 3 * R * (2 * 4 + 2 * 2 + 1)


def vm_projection(model: dict) -> int:
    R = model["vm_sigma_rank"] + model["vm_color_rank"]
    return 3 * 2 * R * (1 + model["geo_feat_dim"])


def forward(model: dict, color: bool = True) -> int:
    """Forward FLOPs of one sample; color=False is the density query."""
    if model["model_type"] == "vm":
        f = vm_interp(model) + vm_projection(model)
    else:
        f = hash_interp(model) + _mlp(sigma_net_dims(model))
    if color:
        f += _mlp(color_net_dims(model))
    return f


def sample_flops(model: dict, trained: bool, color: bool = True) -> int:
    return forward(model, color) * (3 if trained else 1)
