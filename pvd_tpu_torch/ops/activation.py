"""Truncated exponential (port of pvd_tpu/ops/activation.py:12-23), and
the fields' logit clip.

Forward is an exact exp; the derivative uses the input clamped to
[-12, 12] so large density logits cannot blow up gradients.

`clip` is `jnp.clip` with its gradient: a maximum, then a minimum, each
passing half the gradient to an input that ties the bound.  So a value
exactly on a bound gets half its gradient, where `Tensor.clamp` passes
all of it.  In bf16 the heads' sigma logit lands exactly on -2 often
(its spacing there is 1/64), so the difference shows in training.
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


def clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi), its gradient included (see the module)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))
