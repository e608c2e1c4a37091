"""The plain training step of the distillation cell: the three-stage
distillation loss at stage 3, followed by optax's AdamW (betas 0.9 /
0.99, eps 1e-15, weight decay 0.01) under the recipe's learning-rate
schedules (a frozen copy of
`pvd_tpu_torch/engine/{train_steps,optim}.py` as of the benchmark's
definition)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import nerf

B1, B2, EPS, WD = 0.9, 0.99, 1e-15, 0.01


def cosine(lr: float, iters: int, eta_min: float = 5e-5):
    def sched(k):
        t = min(max(k / iters, 0.0), 1.0)
        return eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t))
    return sched


class AdamW:
    """AdamW over a dict of leaves, each with its schedule."""

    def __init__(self, params: dict, schedules: dict):
        self.schedules = schedules
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict):
        k = self.count
        bc1, bc2 = 1.0 - B1 ** (k + 1), 1.0 - B2 ** (k + 1)
        for n, p in params.items():
            g = grads[n]
            self.mu[n].mul_(B1).add_(g, alpha=1.0 - B1)
            self.nu[n].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + EPS)
            p.add_(upd + WD * p, alpha=-float(self.schedules[n](k)))
        self.count += 1


def schedules(names, lr: float, iters: int) -> dict:
    """The recipe's schedules: a distilled VM student anneals lr by
    cosine, its color_net and basis_mat from 1e-3."""
    out = {}
    for n in names:
        if n.split(".")[0] in ("color_net", "basis_mat"):
            out[n] = cosine(1e-3, iters)
        else:
            out[n] = cosine(lr, iters)
    return out


def _backward_update(params: dict, opt: AdamW, loss) -> dict:
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g)
             for (n, p), g in zip(params.items(), grads)}
    opt.update(params, grads)
    return grads


def _masked_l2(pred, gt, valid):
    diff = pred - gt
    m = valid.to(diff.dtype)
    if diff.ndim > m.ndim:
        m = m[..., None]
    diff = diff * m
    n = torch.clamp_min(torch.broadcast_to(m, diff.shape).sum(), 1.0)
    return (diff ** 2).sum() / n


def distill_step(params: dict, opt: AdamW, step: int, teacher: dict, model_s,
                 model_t, render, cfg, bitfield, aabb, pose, intr, H, W, inds,
                 bg, u, prec=nerf.FULL):
    """One stage-3 distillation step: the student's perturbed render, the
    frozen teacher's replay of its samples, the feature, sigma, color and
    RGB L2 losses and the VM density L1, AdamW.  Returns (loss, grads)."""
    o, d = nerf.rays(pose, intr, inds, H, W)
    img_s, (s_s, fea_s, rgb_s), valid, samples = nerf.render_train(
        params, model_s, render, bitfield, aabb, o, d, bg, u, prec=prec)
    with torch.no_grad():
        img_t, (s_t, fea_t, rgb_t), _, _ = nerf.render_train(
            teacher, model_t, render, bitfield, aabb, o, d, bg, u,
            samples=samples, prec=prec)
    rate_fea = float(np.float32(cfg["loss_rate_fea_sc"])
                     * np.float32(0.995) ** np.float32(step))
    loss = rate_fea * _masked_l2(fea_s, fea_t, valid)
    loss = loss + cfg["loss_rate_sigma"] * _masked_l2(s_s, s_t, valid)
    loss = loss + cfg["loss_rate_color"] * _masked_l2(rgb_s, rgb_t, valid)
    loss = loss + cfg["loss_rate_rgb"] * ((img_s - img_t) ** 2).mean()
    loss = loss + cfg["l1_reg_weight"] * nerf.vm_density_l1(
        params, model_s["vm_sigma_rank"])
    return loss.detach(), _backward_update(params, opt, loss)
