"""Alpha compositing (port of pvd_tpu/ops/composite.py:28-123).

  alpha_i  = 1 - exp(-sigma_i * dt_i)            (zero on invalid slots)
  T_i      = prod_{j<i, same ray} (1 - alpha_j)  (exclusive)
  weight_i = alpha_i * T_i, with alpha zeroed where T_i < 1e-4 when
             early_stop (T itself is taken from the unmodified alphas)
  per ray: weights_sum, depth = sum w * t_cum, image = sum w * rgb

`composite_rays_compact` works on the compacted sample stream: kernel K3
(`csrc/composite.cu`) on CUDA tensors, `composite_rays_compact_plain` on
CPU tensors.  `composite_rays` (padded [N, S] blocks) is plain PyTorch.
"""

from __future__ import annotations

import torch

from pvd_tpu_torch import kernels

T_EPS = 1e-4  # inference early-termination threshold


def composite_rays_compact_plain(sigmas, rgbs, delta_t, t_cum, ray_id,
                                 valid, n_rays: int,
                                 early_stop: bool = False):
    """Plain PyTorch composite of a compacted stream.

    Valid slots form a prefix and each ray's valid slots are contiguous
    (what `compact_samples` produces; invalid slots may carry any ray id).
    The segmented exclusive product is an ordinary cumprod over a padded
    [N, maxlen] block (a log-space cumsum would turn alpha = 1 into NaN).
    """
    M = sigmas.shape[0]
    m = valid.to(sigmas.dtype)
    alphas = (1.0 - torch.exp(-sigmas * delta_t)) * m
    rid = ray_id.long()
    counts = torch.zeros(n_rays, dtype=torch.long, device=sigmas.device)
    counts.index_add_(0, rid, valid.long())
    rstart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(M, device=sigmas.device) - rstart[rid]
    maxlen = int(counts.max()) if n_rays else 0
    block = torch.ones(n_rays, maxlen + 1, device=sigmas.device)
    # invalid slots park at the spare last column, which is never read back
    col = torch.where(valid, rank, torch.full_like(rank, maxlen))
    block[rid, col] = torch.where(valid, 1.0 - alphas, 1.0)
    excl = torch.cat([torch.ones_like(block[:, :1]),
                      torch.cumprod(block, dim=1)[:, :-1]], dim=1)
    trans = torch.where(valid, excl[rid, col], 1.0)
    if early_stop:
        alphas = torch.where(trans < T_EPS, 0.0, alphas)
    weights = alphas * trans
    payload = torch.cat([weights[:, None] * rgbs, weights[:, None],
                         (weights * t_cum * m)[:, None]], dim=-1)
    acc = torch.zeros(n_rays, 5, device=sigmas.device)
    acc.index_add_(0, rid, payload)
    return acc[:, 3], acc[:, 4], acc[:, :3], weights


def composite_rays_compact(sigmas, rgbs, delta_t, t_cum, ray_id, valid,
                           n_rays: int, early_stop: bool = False):
    """Composite a compacted sample stream.

    Args: sigmas, delta_t, t_cum, valid [M]; rgbs [M, 3]; ray_id [M] int64
    owner of each slot (see `composite_rays_compact_plain` for the layout).
    Returns weights_sum [N], depth [N], image [N, 3], weights [M].
    """
    if sigmas.device.type == "cpu":
        return composite_rays_compact_plain(sigmas, rgbs, delta_t, t_cum,
                                            ray_id, valid, n_rays, early_stop)
    dev = kernels.check_cuda("composite_rays_compact", sigmas=sigmas,
                             rgbs=rgbs, delta_t=delta_t, t_cum=t_cum,
                             ray_id=ray_id, valid=valid)
    kernels.check_no_grad("composite_rays_compact", sigmas, rgbs)
    M = sigmas.shape[0]
    for name, t in (("sigmas", sigmas), ("delta_t", delta_t),
                    ("t_cum", t_cum), ("rgbs", rgbs)):
        if t.dtype != torch.float32:
            raise TypeError(f"composite_rays_compact: {name} must be float32")
    if rgbs.shape != (M, 3) or delta_t.shape != (M,) or t_cum.shape != (M,) \
            or ray_id.shape != (M,) or valid.shape != (M,):
        raise ValueError("composite_rays_compact: shape mismatch")
    if ray_id.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("composite_rays_compact: ray_id int64, valid bool")
    bounds = torch.zeros(2, n_rays, dtype=torch.int32, device=dev)
    weights = torch.empty(M, device=dev)
    ws = torch.empty(n_rays, device=dev)
    depth = torch.empty(n_rays, device=dev)
    image = torch.empty(n_rays, 3, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_composite_compact_fwd", sigmas.data_ptr(),
                       rgbs.data_ptr(), delta_t.data_ptr(), t_cum.data_ptr(),
                       ray_id.data_ptr(), valid.data_ptr(), M, n_rays,
                       int(early_stop), bounds.data_ptr(), weights.data_ptr(),
                       ws.data_ptr(), depth.data_ptr(), image.data_ptr(),
                       kernels.stream_ptr(sigmas))
    composite_rays_compact.launches += 1
    return ws, depth, image, weights


composite_rays_compact.launches = 0


def composite_rays(sigmas, rgbs, delta_t, delta_depth, mask,
                   early_stop: bool = False):
    """Composite padded per-ray samples [N, S] (composite.py:97-123).
    Returns weights_sum [N], depth [N], image [N, 3], weights [N, S]."""
    m = mask.to(sigmas.dtype)
    alphas = (1.0 - torch.exp(-sigmas * delta_t)) * m
    cp = torch.cumprod(1.0 - alphas, dim=-1)
    trans = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    if early_stop:
        alphas = torch.where(trans < T_EPS, 0.0, alphas)
    weights = alphas * trans
    t_cum = torch.cumsum(delta_depth * m, dim=-1)
    return (weights.sum(-1), (weights * t_cum).sum(-1),
            (weights[..., None] * rgbs).sum(-2), weights)
