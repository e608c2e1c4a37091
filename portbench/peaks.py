"""H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit) and the
roofline arithmetic (`bound` is a copy of chip_smoke.py:785)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound(bytes_moved: float, ops: float):
    """The least time in ms, and which of bytes or operations sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k8_bound(N: int, S: int, n_valid: int) -> tuple:
    """K8's bound (chip_smoke.py:1823): the mask, the valid slots' sigma,
    dt, delta_depth and rgb read once, the weights and per-ray sums
    written once; ~16 ops a valid slot."""
    return bound(N * S + n_valid * 24 + N * S * 4 + N * 20, n_valid * 16)


def k9_bound(N: int, S: int, n_valid: int) -> tuple:
    """K9's bound (chip_smoke.py:1815): the mask, the valid slots' inputs,
    the per-ray upstream gradients read once, both outputs written once;
    ~30 ops a valid slot."""
    return bound(N * S + n_valid * 32 + N * 20 + N * S * 16, n_valid * 30)
