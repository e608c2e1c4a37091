"""Truncated exponential (port of pvd_tpu/ops/activation.py:12-23).

Forward is an exact exp; the derivative uses the input clamped to
[-12, 12] so large density logits cannot blow up gradients.
"""

from __future__ import annotations

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-12.0, 12.0))


def trunc_exp(x):
    return TruncExp.apply(x)
