"""Alpha compositing (port of pvd_tpu/ops/composite.py:28-145).

  alpha_i  = 1 - exp(-sigma_i * dt_i)            (zero on invalid slots)
  T_i      = prod_{j<i, same ray} (1 - alpha_j)  (exclusive)
  weight_i = alpha_i * T_i, with alpha zeroed where T_i < 1e-4 when
             early_stop (T itself is taken from the unmodified alphas)
  per ray: weights_sum, depth = sum w * t_cum, image = sum w * rgb

`composite_rays_compact` works on the compacted sample stream: kernel K3
forward and K6 backward (`csrc/composite.cu`) on CUDA tensors,
`composite_rays_compact_plain` (differentiated by autograd) on CPU
tensors.  `composite_rays` works on padded [N, S] blocks: kernel K8
forward and K9 backward on CUDA tensors, `composite_rays_plain` on CPU
tensors.  Neither backward sends a gradient to dt, t_cum or delta_depth
(they come from the march).  `composite_stratified`, the occupancy-free
path's dense [N, T] composite, is plain PyTorch on every device.
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


def _check_stream(name, sigmas, rgbs, delta_t, t_cum, ray_id, valid):
    dev = kernels.check_cuda(name, sigmas=sigmas, rgbs=rgbs,
                             delta_t=delta_t, t_cum=t_cum, ray_id=ray_id,
                             valid=valid)
    M = sigmas.shape[0]
    for n, t in (("sigmas", sigmas), ("delta_t", delta_t), ("t_cum", t_cum),
                 ("rgbs", rgbs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {n} must be float32")
    if rgbs.shape != (M, 3) or delta_t.shape != (M,) or t_cum.shape != (M,) \
            or ray_id.shape != (M,) or valid.shape != (M,):
        raise ValueError(f"{name}: shape mismatch")
    if ray_id.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: ray_id int64, valid bool")
    return dev


def k3_lanes(n_samples: int, n_rays: int) -> int:
    """Lanes per ray of K3's pass 2, from the mean budget per ray: 16 up to
    16 slots per ray (the serving ladder's 1x rung, the training budgets),
    32 above (its 4x and 16x rungs), where a ray's range spans tiles."""
    return 16 if n_samples <= 16 * n_rays else 32


def composite_rays_compact_fwd(sigmas, rgbs, delta_t, t_cum, ray_id, valid,
                               n_rays: int, early_stop: bool = False):
    """Kernel K3 on CUDA tensors, no autograd.  Returns weights_sum [N],
    depth [N], image [N, 3], weights [M] and the per-ray slot bounds
    [2, N] int32 that the backward (K6) reuses."""
    dev = _check_stream("composite_rays_compact", sigmas, rgbs, delta_t,
                        t_cum, ray_id, valid)
    M = sigmas.shape[0]
    bounds = torch.empty(2, n_rays, dtype=torch.int32, device=dev)
    weights = torch.empty(M, device=dev)
    ws = torch.empty(n_rays, device=dev)
    depth = torch.empty(n_rays, device=dev)
    image = torch.empty(n_rays, 3, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_composite_compact_fwd", sigmas.data_ptr(),
                       rgbs.data_ptr(), delta_t.data_ptr(), t_cum.data_ptr(),
                       ray_id.data_ptr(), valid.data_ptr(), M, n_rays,
                       int(early_stop), k3_lanes(M, n_rays),
                       bounds.data_ptr(), weights.data_ptr(),
                       ws.data_ptr(), depth.data_ptr(), image.data_ptr(),
                       kernels.stream_ptr(sigmas))
    composite_rays_compact.launches += 1
    return ws, depth, image, weights, bounds


def composite_rays_compact_bwd(sigmas, rgbs, delta_t, t_cum, ray_id, valid,
                               weights, bounds, g_ws, g_depth, g_image,
                               g_weights):
    """Kernel K6: gradients (d sigmas [M], d rgbs [M, 3]) of a compacted
    composite from the upstream gradients of weights_sum [N], depth [N],
    image [N, 3] and weights [M]; `weights` and `bounds` come from
    `composite_rays_compact_fwd` (no early stop) on the stream `ray_id`,
    `valid`.  The kernel writes every slot, the zeros of those no ray owns
    too.  CUDA tensors only: on the CPU autograd differentiates the plain
    version."""
    n_rays = bounds.shape[1]
    M = sigmas.shape[0]
    grads = {"g_ws": (g_ws, (n_rays,)), "g_depth": (g_depth, (n_rays,)),
             "g_image": (g_image, (n_rays, 3)), "g_weights": (g_weights, (M,))}
    for n, (t, shape) in grads.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"composite_rays_compact_bwd: {n} must be "
                             f"float32 {shape}")
    g_ws, g_depth, g_image, g_weights = (
        t.contiguous() for t in (g_ws, g_depth, g_image, g_weights))
    dev = _check_stream("composite_rays_compact_bwd", sigmas, rgbs, delta_t,
                        t_cum, ray_id, valid)
    kernels.check_cuda("composite_rays_compact_bwd", sigmas=sigmas,
                       weights=weights, bounds=bounds, g_ws=g_ws,
                       g_depth=g_depth, g_image=g_image, g_weights=g_weights)
    d_sigma = torch.empty(M, device=dev)
    d_rgb = torch.empty(M, 3, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_composite_compact_bwd", sigmas.data_ptr(),
                       rgbs.data_ptr(), delta_t.data_ptr(), t_cum.data_ptr(),
                       weights.data_ptr(), bounds.data_ptr(),
                       ray_id.data_ptr(), valid.data_ptr(), M, n_rays,
                       k3_lanes(M, n_rays), g_ws.data_ptr(),
                       g_depth.data_ptr(), g_image.data_ptr(),
                       g_weights.data_ptr(), d_sigma.data_ptr(),
                       d_rgb.data_ptr(), kernels.stream_ptr(sigmas))
    composite_rays_compact_bwd.launches += 1
    return d_sigma, d_rgb


composite_rays_compact_bwd.launches = 0


class _CompositeCompact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, rgbs, delta_t, t_cum, ray_id, valid, n_rays,
                early_stop):
        ws, depth, image, weights, bounds = composite_rays_compact_fwd(
            sigmas, rgbs, delta_t, t_cum, ray_id, valid, n_rays, early_stop)
        ctx.save_for_backward(sigmas, rgbs, delta_t, t_cum, ray_id, valid,
                              weights, bounds)
        ctx.early_stop = early_stop
        return ws, depth, image, weights

    @staticmethod
    def backward(ctx, g_ws, g_depth, g_image, g_weights):
        if ctx.early_stop:
            raise NotImplementedError(
                "composite_rays_compact: no backward with early_stop=True "
                "(an inference-only setting)")
        d_sigma, d_rgb = composite_rays_compact_bwd(
            *ctx.saved_tensors, g_ws, g_depth, g_image, g_weights)
        return d_sigma, d_rgb, None, None, None, None, None, None


def composite_rays_compact(sigmas, rgbs, delta_t, t_cum, ray_id, valid,
                           n_rays: int, early_stop: bool = False):
    """Composite a compacted sample stream, differentiable in sigmas and
    rgbs.

    Args: sigmas, delta_t, t_cum, valid [M]; rgbs [M, 3]; ray_id [M] int64
    owner of each slot (see `composite_rays_compact_plain` for the layout).
    Returns weights_sum [N], depth [N], image [N, 3], weights [M].
    CUDA tensors: forward K3, backward K6 (`csrc/composite.cu`); CPU
    tensors: the plain version, differentiated by autograd.
    """
    if sigmas.device.type == "cpu":
        return composite_rays_compact_plain(sigmas, rgbs, delta_t, t_cum,
                                            ray_id, valid, n_rays, early_stop)
    return _CompositeCompact.apply(sigmas, rgbs, delta_t, t_cum, ray_id,
                                   valid, n_rays, early_stop)


composite_rays_compact.launches = 0


def exclusive_cumprod_one_minus(alphas):
    """T_i = prod_{j<i} (1 - alpha_j) along the last axis, a shifted
    cumprod (composite.py:90-94)."""
    cp = torch.cumprod(1.0 - alphas, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def composite_rays_plain(sigmas, rgbs, delta_t, delta_depth, mask,
                         early_stop: bool = False):
    """Composite padded per-ray samples [N, S] (composite.py:97-123).
    Returns weights_sum [N], depth [N], image [N, 3], weights [N, S]."""
    m = mask.to(sigmas.dtype)
    alphas = (1.0 - torch.exp(-sigmas * delta_t)) * m
    trans = exclusive_cumprod_one_minus(alphas)
    if early_stop:
        alphas = torch.where(trans < T_EPS, 0.0, alphas)
    weights = alphas * trans
    t_cum = torch.cumsum(delta_depth * m, dim=-1)
    return (weights.sum(-1), (weights * t_cum).sum(-1),
            (weights[..., None] * rgbs).sum(-2), weights)


def _check_padded(name, sigmas, rgbs, delta_t, delta_depth, mask):
    dev = kernels.check_cuda(name, sigmas=sigmas, rgbs=rgbs, delta_t=delta_t,
                             delta_depth=delta_depth, mask=mask)
    if sigmas.ndim != 2:
        raise ValueError(f"{name}: sigmas must be [N, S]")
    N, S = sigmas.shape
    for n, t, shape in (("sigmas", sigmas, (N, S)), ("rgbs", rgbs, (N, S, 3)),
                        ("delta_t", delta_t, (N, S)),
                        ("delta_depth", delta_depth, (N, S))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {n} must be float32 {shape}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (N, S):
        raise ValueError(f"{name}: mask must be bool {(N, S)}")
    return dev


def composite_rays_fwd(sigmas, rgbs, delta_t, delta_depth, mask,
                       early_stop: bool = False):
    """Kernel K8 on CUDA tensors, no autograd.  Returns weights_sum [N],
    depth [N], image [N, 3], weights [N, S]."""
    dev = _check_padded("composite_rays", sigmas, rgbs, delta_t, delta_depth,
                        mask)
    N, S = sigmas.shape
    weights = torch.empty(N, S, device=dev)
    ws = torch.empty(N, device=dev)
    depth = torch.empty(N, device=dev)
    image = torch.empty(N, 3, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_composite_padded_fwd", sigmas.data_ptr(),
                       rgbs.data_ptr(), delta_t.data_ptr(),
                       delta_depth.data_ptr(), mask.data_ptr(), N, S,
                       int(early_stop), weights.data_ptr(), ws.data_ptr(),
                       depth.data_ptr(), image.data_ptr(),
                       kernels.stream_ptr(sigmas))
    composite_rays.launches += 1
    return ws, depth, image, weights


def composite_rays_bwd(sigmas, rgbs, delta_t, delta_depth, mask, weights,
                       g_ws, g_depth, g_image, g_weights):
    """Kernel K9: gradients (d sigmas [N, S], d rgbs [N, S, 3]) of a padded
    composite (no early stop) from the upstream gradients of weights_sum
    [N], depth [N], image [N, 3] and weights [N, S]; `weights` comes from
    `composite_rays_fwd`.  The kernel writes every slot (a masked one's
    zeros too) with a warp a ray.  CUDA tensors only;
    `composite_rays_bwd_plain` is its PyTorch version."""
    N, S = sigmas.shape
    grads = {"g_ws": (g_ws, (N,)), "g_depth": (g_depth, (N,)),
             "g_image": (g_image, (N, 3)), "g_weights": (g_weights, (N, S)),
             "weights": (weights, (N, S))}
    for n, (t, shape) in grads.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"composite_rays_bwd: {n} must be float32 "
                             f"{shape}")
    g_ws, g_depth, g_image, g_weights = (
        t.contiguous() for t in (g_ws, g_depth, g_image, g_weights))
    dev = _check_padded("composite_rays_bwd", sigmas, rgbs, delta_t,
                        delta_depth, mask)
    kernels.check_cuda("composite_rays_bwd", sigmas=sigmas, weights=weights,
                       g_ws=g_ws, g_depth=g_depth, g_image=g_image,
                       g_weights=g_weights)
    d_sigma = torch.empty(N, S, device=dev)
    d_rgb = torch.empty(N, S, 3, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("pvd_composite_padded_bwd", sigmas.data_ptr(),
                       rgbs.data_ptr(), delta_t.data_ptr(),
                       delta_depth.data_ptr(), mask.data_ptr(),
                       weights.data_ptr(), N, S, g_ws.data_ptr(),
                       g_depth.data_ptr(), g_image.data_ptr(),
                       g_weights.data_ptr(), d_sigma.data_ptr(),
                       d_rgb.data_ptr(), kernels.stream_ptr(sigmas))
    composite_rays_bwd.launches += 1
    return d_sigma, d_rgb


composite_rays_bwd.launches = 0


def composite_rays_bwd_plain(sigmas, rgbs, delta_t, delta_depth, mask,
                             g_ws, g_depth, g_image, g_weights):
    """K9's PyTorch version: autograd through `composite_rays_plain`."""
    s = sigmas.detach().requires_grad_()
    r = rgbs.detach().requires_grad_()
    with torch.enable_grad():
        outs = composite_rays_plain(s, r, delta_t, delta_depth, mask)
        return torch.autograd.grad(outs, (s, r),
                                   (g_ws, g_depth, g_image, g_weights))


class _CompositePadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, rgbs, delta_t, delta_depth, mask, early_stop):
        ws, depth, image, weights = composite_rays_fwd(
            sigmas, rgbs, delta_t, delta_depth, mask, early_stop)
        ctx.save_for_backward(sigmas, rgbs, delta_t, delta_depth, mask,
                              weights)
        ctx.early_stop = early_stop
        return ws, depth, image, weights

    @staticmethod
    def backward(ctx, g_ws, g_depth, g_image, g_weights):
        if ctx.early_stop:
            raise NotImplementedError(
                "composite_rays: no backward with early_stop=True (an "
                "inference-only setting)")
        d_sigma, d_rgb = composite_rays_bwd(*ctx.saved_tensors, g_ws,
                                            g_depth, g_image, g_weights)
        return d_sigma, d_rgb, None, None, None, None


def composite_rays(sigmas, rgbs, delta_t, delta_depth, mask,
                   early_stop: bool = False):
    """Composite padded per-ray samples [N, S], differentiable in sigmas
    and rgbs.

    Args: sigmas, delta_t, delta_depth [N, S] float32; rgbs [N, S, 3];
    mask [N, S] bool.  Returns weights_sum [N], depth [N], image [N, 3],
    weights [N, S].  CUDA tensors: forward K8, backward K9
    (`csrc/composite.cu`); CPU tensors: the plain version, differentiated
    by autograd.
    """
    if sigmas.device.type == "cpu":
        return composite_rays_plain(sigmas, rgbs, delta_t, delta_depth, mask,
                                    early_stop)
    return _CompositePadded.apply(
        sigmas.contiguous(), rgbs.contiguous(), delta_t.contiguous(),
        delta_depth.contiguous(), mask.contiguous(), early_stop)


composite_rays.launches = 0


def stratified_weights(sigmas, z_vals, sample_dist):
    """The stratified path's weights [N, T] (composite.py:131-140): each
    sample's delta is the gap to the next z, the last one `sample_dist`,
    and the transmittance multiplies 1 - alpha + 1e-15, as the
    reference does."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])],
                       dim=-1)
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-15], dim=-1)
    return alphas * torch.cumprod(shifted, dim=-1)[..., :-1]


def composite_stratified(sigmas, z_vals, sample_dist, rgbs):
    """Compositing of the fixed-count stratified path (composite.py:126;
    the reference's renderer.py:257-295), plain PyTorch differentiated by
    autograd: the JAX package has no custom VJP for it.

    sigmas: [N, T]; z_vals: [N, T]; sample_dist: [N, 1]; rgbs: [N, T, 3].
    Returns weights_sum [N], weights [N, T], image [N, 3]."""
    weights = stratified_weights(sigmas, z_vals, sample_dist)
    weights_sum = torch.sum(weights, dim=-1)
    image = torch.sum(weights[..., None] * rgbs, dim=-2)
    return weights_sum, weights, image
