"""Sample-budget auto-tuning (port of pvd_tpu/engine/autotune.py).

The reference adapts its ragged point-buffer size from a 16-slot step
counter ring (raymarching/raymarching.py:233-238, renderer.py:767-773).
Two shape knobs are tuned from measured occupancy statistics, in
power-of-two-ish buckets:

  * max_samples (S_max): the padded per-ray slot count.  budget_hit (the
    fraction of rays whose last slot is valid) > 25% escalates; a mostly
    padding block shrinks back.
  * samples_per_ray: the global compacted-point budget per ray, tracking
    ~1.2x the measured batch-mean valid count.

Pure Python; the logic is the JAX package's, line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from pvd_tpu_torch.config import RenderSpec

SMAX_BUCKETS = (16, 24, 32, 48, 64, 96, 128, 192, 256)
SPR_BUCKETS = (4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0, 96.0)


def choose_buckets(
    rspec: RenderSpec,
    budget_hit: float,
    mask_frac: float,
    allow_shrink: bool = True,
) -> Tuple[int, float]:
    """Pick (max_samples, samples_per_ray) buckets for the measured stats
    (autotune.py:26-64): escalation only past budget_hit 0.25, a shrink
    needs 20% clearance below the target bucket unless it halves."""
    s_max = rspec.max_samples
    if budget_hit > 0.25:
        bigger = [b for b in SMAX_BUCKETS
                  if b > s_max and b <= rspec.max_steps]
        if bigger:
            s_max = bigger[0]
    elif (allow_shrink and budget_hit < 0.02
          and mask_frac * rspec.max_samples < 0.45 * s_max):
        smaller = [b for b in SMAX_BUCKETS if b < s_max]
        if smaller and mask_frac * rspec.max_samples < 0.9 * smaller[-1]:
            s_max = smaller[-1]

    spr = rspec.samples_per_ray
    if spr > 0:
        mean_valid = mask_frac * rspec.max_samples
        want = [b for b in SPR_BUCKETS if b >= 1.2 * mean_valid]
        target = min(want[0] if want else SPR_BUCKETS[-1], float(s_max))
        if (target < spr and target > 0.5 * spr
                and 1.2 * mean_valid > 0.8 * target):
            target = spr
        spr = target
    return s_max, spr


def retune(rspec: RenderSpec, budget_hit: float, mask_frac: float,
           allow_shrink: bool = True) -> Optional[RenderSpec]:
    """New RenderSpec if the buckets changed, else None."""
    s_max, spr = choose_buckets(rspec, budget_hit, mask_frac, allow_shrink)
    if s_max == rspec.max_samples and spr == rspec.samples_per_ray:
        return None
    return dataclasses.replace(rspec, max_samples=s_max, samples_per_ray=spr)
