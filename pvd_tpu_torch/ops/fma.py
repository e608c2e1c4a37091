"""Fused multiply-add in float32, as XLA:CPU computes `a * b + c`.

XLA's CPU backend contracts an f32 multiply feeding an add into one FMA
(a single rounding).  The JAX package's march lattice (`t0 + k * dt_min`),
its sample positions (`o + t * d`), its perturbed start, its ray rotation
and the hash encode's `x01 * scale + 0.5` are all computed that way, so the
port does the same wherever a result must match bit for bit: the CUDA
kernels call `__fmaf_rn`, and the plain PyTorch versions call `fma32`.

`fma32` forms the product exactly in float64 (two 24-bit significands fit
in 53 bits), adds in float64 and rounds once to float32.  That equals the
true FMA whenever the float64 sum is exact, which holds for every lattice
point `t0 + k * dt_min` of the march; otherwise it can differ only when the
float64 sum rounds onto an exact float32 midpoint (probability about 2^-29
per element).
"""

from __future__ import annotations

import torch


def fma32(a, b, c) -> torch.Tensor:
    """float32 round(a * b + c); float32 tensors or Python floats (rounded
    to float32 first, as JAX does with a Python scalar), broadcast."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).double()
               for x in (a, b, c))
    return (a * b + c).float()
