"""Shared sigma/color MLP heads (port of pvd_tpu/models/heads.py:21-59).

`field` is any module with `sigma_net` and `color_net` layer lists.  Two
quirks of the JAX package are kept:
  * the forward path clips only channel 0 of the sigma_net output, the
    density path clips every channel (network.py:481-489 in the reference);
  * `compute_dtype` casts the matmul inputs in the forward path only; the
    density path runs in float32 whatever the dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.common import apply_mlp
from pvd_tpu_torch.ops.activation import trunc_exp
from pvd_tpu_torch.ops.sh import sh_encode

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FieldOut(NamedTuple):
    sigma: torch.Tensor  # [N] post trunc_exp
    rgb: Optional[torch.Tensor]  # [N, 3] post sigmoid (None when !want_color)
    sigma_logit: torch.Tensor  # [N] clipped pre-activation
    fea_sc: Optional[torch.Tensor]  # [N, 1 + geo_feat]


def compute_dtype(spec: ModelSpec) -> torch.dtype:
    return _DTYPES[spec.compute_dtype]


def shared_sigma_color(field, spec: ModelSpec, enc, d,
                       want_color: bool) -> FieldOut:
    """sigma_net -> (clipped sigma logit, geo feature) -> color_net."""
    cdt = compute_dtype(spec)
    h = apply_mlp(field.sigma_net, enc.to(cdt)).float()
    s = h[..., 0].clamp(spec.sigma_clip_min, spec.sigma_clip_max)
    h = torch.cat([s[..., None], h[..., 1:]], dim=-1)
    sigma = trunc_exp(s)
    if not want_color:
        return FieldOut(sigma, None, s, h)
    enc_d = sh_encode(d, spec.dir_sh_degree)
    rgb = apply_mlp(
        field.color_net,
        torch.cat([enc_d, h[..., 1:]], dim=-1).to(cdt),
        final_activation="sigmoid",
    ).float()
    return FieldOut(sigma, rgb, s, h)


def shared_density(field, spec: ModelSpec, enc):
    """Density-only tail: clips ALL channels, float32."""
    h = apply_mlp(field.sigma_net, enc)
    h = h.clamp(spec.sigma_clip_min, spec.sigma_clip_max)
    return trunc_exp(h[..., 0])
