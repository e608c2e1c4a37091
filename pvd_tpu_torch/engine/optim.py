"""Optimizer (port of pvd_tpu/engine/optim.py).

AdamW with betas (0.9, 0.99), eps 1e-15 and weight decay 0.01, in parameter
groups: `main` and `head_lr2` each follow their own learning-rate schedule,
and `frozen` leaves (fix_mlp) get no update at all, not even weight decay
(the JAX package's `optax.set_to_zero`).  The update is optax's:

  mu = b1 * mu + (1 - b1) * g,  nu = b2 * nu + (1 - b2) * g^2
  p -= lr(k) * ((mu / (1 - b1^(k+1))) / (sqrt(nu / (1 - b2^(k+1))) + eps)
                + wd * p)

with k the update's index counted from 0, as optax counts.  Parameters and
moments are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

B1, B2, EPS = 0.9, 0.99, 1e-15  # optim.py:74-77


def exp_decay_schedule(init_lr: float, total_iters: int) -> Callable:
    """LambdaLR 0.1^(it/iters) (optim.py:26-33)."""

    def sched(step: int) -> float:
        return init_lr * 0.1 ** min(step / total_iters, 1.0)

    return sched


def cosine_schedule(init_lr: float, total_iters: int,
                    eta_min: float = 5e-5) -> Callable:
    """CosineAnnealingLR to eta_min (optim.py:36-44)."""

    def sched(step: int) -> float:
        t = min(max(step / total_iters, 0.0), 1.0)
        return eta_min + (init_lr - eta_min) * 0.5 * (1 + math.cos(math.pi
                                                                   * t))

    return sched


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: dict  # name -> first moment (trainable leaves only)
    nu: dict  # name -> second moment


class GroupedAdamW:
    """AdamW over named parameters with one schedule per group label."""

    def __init__(self, labels: Mapping[str, str],
                 schedules: Mapping[str, Callable],
                 weight_decay: float = 0.01):
        unknown = set(labels.values()) - set(schedules) - {"frozen"}
        if unknown:
            raise ValueError(f"no schedule for groups {sorted(unknown)}")
        self.labels = dict(labels)
        self.schedules = dict(schedules)
        self.wd = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        live = [n for n, lab in self.labels.items() if lab != "frozen"]
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(params[n]) for n in live},
            nu={n: torch.zeros_like(params[n]) for n in live})

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: AdamWState):
        """One update of `params` from `grads`, in place."""
        k = state.count
        t = k + 1
        bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        for label, sched in self.schedules.items():
            names = [n for n, lab in self.labels.items() if lab == label]
            if not names:
                continue
            p = [params[n] for n in names]
            g = [grads[n] for n in names]
            mu = [state.mu[n] for n in names]
            nu = [state.nu[n] for n in names]
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, g, alpha=1.0 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, p, alpha=self.wd)
            torch._foreach_add_(p, upd, alpha=-float(sched(k)))
        state.count = t


def build_optimizer(params: Mapping[str, torch.Tensor], label_fn: Callable,
                    trainable_fn: Callable, schedule_main: Callable,
                    schedule_lr2: Callable,
                    weight_decay: float = 0.01) -> GroupedAdamW:
    """AdamW with per-group schedules and optional frozen leaves
    (optim.py:47-86).  `params` maps names (`module.named_parameters()`) to
    tensors; label_fn(path) -> 'main' | 'head_lr2' and trainable_fn(path)
    -> bool take the name split at its dots."""
    labels = {}
    for name in params:
        path = tuple(name.split("."))
        labels[name] = label_fn(path) if trainable_fn(path) else "frozen"
    return GroupedAdamW(labels, {"main": schedule_main,
                                 "head_lr2": schedule_lr2},
                        weight_decay=weight_decay)


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float):
    """torch_ema-style shadow update, in place (optim.py:89-93)."""
    for name, e in ema_params.items():
        e.mul_(decay).add_(params[name], alpha=1.0 - decay)
