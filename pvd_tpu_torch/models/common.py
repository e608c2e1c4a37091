"""Shared MLP building blocks (port of pvd_tpu/models/common.py:38-58).

The heads are bias-free `nn.Linear` stacks.  The JAX package stores a
layer's weight as `w` [in, out]; `nn.Linear.weight` is its transpose
[out, in] (params.py converts).  `nn.Linear`'s default init is the JAX
package's: uniform with bound 1/sqrt(fan_in).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def mlp_dims(in_dim: int, hidden: int, out_dim: int, num_layers: int):
    return [in_dim] + [hidden] * (num_layers - 1) + [out_dim]


def make_mlp(dims: Sequence[int], device=None) -> nn.ModuleList:
    """dims: [in, h, ..., out] -> bias-free Linear layers."""
    return nn.ModuleList(
        nn.Linear(dims[i], dims[i + 1], bias=False, device=device)
        for i in range(len(dims) - 1))


def apply_mlp(layers: Sequence[nn.Linear], x,
              final_activation: Optional[str] = None):
    """ReLU between layers, none after the last; weights are cast to the
    input's dtype (the `compute_dtype` matmul, common.py:31-35)."""
    for i, lin in enumerate(layers):
        x = F.linear(x, lin.weight.to(x.dtype))
        if i != len(layers) - 1:
            x = torch.relu(x)
    if final_activation == "sigmoid":
        x = torch.sigmoid(x)
    return x
