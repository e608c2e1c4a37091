"""Fixed-count stratified sampling and inverse-CDF importance sampling
(port of pvd_tpu/ops/sampling.py).

The sampler behind the occupancy-free render path (`render/renderer.py`
`render_stratified`; the reference's `run` and `sample_pdf`): dense
[n_rays, n_steps] tensor programs in plain PyTorch.  Random draws are
arguments: each function takes its uniform draws as a tensor `u`, or
draws them from an explicit `torch.Generator`, so a test can hand both
packages the JAX package's draws.

The op order is the JAX functions' own, op by op.  `linspace_f32` gives
`jnp.linspace`'s float32 values, which `torch.linspace` does not (on
this box it differs at 32 of 512 points of linspace(0, 1, 512)).
"""

from __future__ import annotations

import torch

from pvd_tpu_torch.ops.fma import fma32


def linspace_f32(start: float, stop: float, n: int, device="cpu"):
    """`jnp.linspace(start, stop, n)` in float32: XLA:CPU computes it as
    start * (1 - i * c) + i * (stop * c), c = float32(1 / (n - 1)), with
    the two multiply-adds contracted into FMAs, and the end point exact.
    Bit for bit JAX's at (0, 1) for every n, and at `sample_pdf`'s
    (0.5 / n, 1 - 0.5 / n) for every power of two; for 45 other n in
    [2, 1100] a few points differ by an ulp or two."""
    if n == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = n - 1
    c = torch.tensor(1.0 / div, dtype=torch.float32).item()
    i = torch.arange(div, dtype=torch.float32, device=device)
    s = torch.tensor(start, dtype=torch.float32).item()
    e = torch.tensor(stop, dtype=torch.float32).item()
    ec = torch.tensor(e * c, dtype=torch.float32).item()
    one_minus = fma32(-i, c, 1.0)
    out = fma32(i, ec, s * one_minus)
    return torch.cat([out, torch.tensor([e], dtype=torch.float32,
                                        device=device)])


def stratified_z_vals(nears, fars, num_steps: int, perturb: bool, u=None,
                      generator: torch.Generator | None = None):
    """A linspace in [near, far] per ray, jittered by +-0.5 bins when
    `perturb` (sampling.py:13-26).

    nears, fars: [N].  u: [N, num_steps] uniform draws in [0, 1) for the
    jitter (drawn from `generator` when None).  Returns z_vals
    [N, num_steps] and sample_dist [N, 1]."""
    nears = nears[..., None]
    fars = fars[..., None]
    t = linspace_f32(0.0, 1.0, num_steps, nears.device)[None, :]
    z = nears + (fars - nears) * t
    sample_dist = (fars - nears) / num_steps
    if perturb:
        if u is None:
            u = torch.rand(z.shape, generator=generator, device=z.device)
        z = z + (u - 0.5) * sample_dist
    return z, sample_dist


def sample_pdf(bins, weights, n_samples: int, det: bool = False, u=None,
               generator: torch.Generator | None = None):
    """Inverse-CDF sampling of new z values, NeRF's hierarchical sampling
    (sampling.py:29-57).

    bins: [N, T] (z midpoints); weights: [N, T-1].  u: [N, n_samples]
    uniform draws; when None, the JAX package's evenly spaced quantiles
    with `det`, else draws from `generator`.  Returns [N, n_samples].

    The CDF is a running sum: a u within an ulp of a CDF step can fall in
    the neighbouring bin where the JAX package sums in another order.
    The sample moves by a rounding error there, since the interpolation
    meets at the step, unless the bin is one whose CDF rise is under
    1e-5 (its denominator is clamped to 1)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det:
            u = linspace_f32(0.5 / n_samples, 1.0 - 0.5 / n_samples,
                             n_samples, cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
