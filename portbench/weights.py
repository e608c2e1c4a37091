"""Weights from the seed, made on the device in a few large calls, named as
the program's parameters (`encoder`, `sigma_net.0.weight` [out, in],
`planes.0` [H, W, Rs + Rc], `lines.0`, `basis_mat`, `color_net.2.weight`).

The inits are the recipe's (`init: "recipe"`): tables U(-1e-4, 1e-4),
VM planes and lines N(0, 0.1^2), bias-free layers U(+-1/sqrt(fan_in)).
`init: "wide"` draws a hash table from U(-0.5, 0.5) (chip_smoke.py:668
random_hash_params): a frozen random teacher whose levels all differ.
`scale_density` then widens such a field's densities (see there).
"""

from __future__ import annotations

import torch

from portbench.reference.nerf import MAT_IDS, VEC_IDS, grid_of


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def _mlp(prefix: str, dims, gen, device) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.rand(b, a, generator=gen, device=device)
        out[f"{prefix}.{i}.weight"] = (w * 2.0 - 1.0) / a ** 0.5
    return out


def head_dims(model: dict) -> dict:
    sh = model["sh_degree"] ** 2
    geo = model["geo_feat_dim"]
    color = [sh + geo] + [model["hidden_dim_color"]] * (
        model["num_layers_color"] - 1) + [3]
    return {"color_net": color}


def hash_weights(model: dict, init: str, gen, device) -> dict:
    g = grid_of(model)
    table = torch.rand(g.table_rows, g.level_dim, generator=gen,
                       device=device)
    amp = 0.5 if init == "wide" else 1e-4
    w = {"encoder": (table * 2.0 - 1.0) * amp}
    sigma = [g.num_levels * g.level_dim] + [model["hidden_dim"]] * (
        model["num_layers"] - 1) + [1 + model["geo_feat_dim"]]
    w.update(_mlp("sigma_net", sigma, gen, device))
    w.update(_mlp("color_net", head_dims(model)["color_net"], gen, device))
    return w


def vm_weights(model: dict, gen, device) -> dict:
    res = model["vm_resolution"]
    R = model["vm_sigma_rank"] + model["vm_color_rank"]
    w = {}
    for i, (m0, m1) in enumerate(MAT_IDS):
        w[f"planes.{i}"] = 0.1 * torch.randn(res[m1], res[m0], R,
                                             generator=gen, device=device)
    for i, v in enumerate(VEC_IDS):
        w[f"lines.{i}"] = 0.1 * torch.randn(res[v], R, generator=gen,
                                            device=device)
    n_in = 3 * model["vm_color_rank"]
    basis = torch.rand(n_in, model["geo_feat_dim"], generator=gen,
                       device=device)
    w["basis_mat"] = (basis * 2.0 - 1.0) / n_in ** 0.5
    w.update(_mlp("color_net", head_dims(model)["color_net"], gen, device))
    return w


def make(model: dict, init: str, gen, device) -> dict:
    if model["model_type"] == "vm":
        return vm_weights(model, gen, device)
    return hash_weights(model, init, gen, device)


@torch.no_grad()
def scale_density(w: dict, gain: float):
    """Scale the sigma net's density output row by `gain`, in place.  The
    random field's raw density then spreads over the clip range (at 100,
    its 90th percentile ~e^4) instead of staying near 0, so that rays
    through solid parts of a grid turn opaque and stop early, as they do
    in a trained object."""
    last = max((n for n in w if n.startswith("sigma_net.")),
               key=lambda n: int(n.split(".")[1]))
    w[last][0] *= gain


@torch.no_grad()
def load_into(field, w: dict):
    """Copy `w` into the program's field, parameter by parameter."""
    params = dict(field.named_parameters())
    if set(params) != set(w):
        raise ValueError(f"weights {sorted(w)} do not match the field's "
                         f"parameters {sorted(params)}")
    for n, p in params.items():
        p.copy_(w[n])
