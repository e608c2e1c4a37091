"""Classic NeRF frequency positional encoding (port of
pvd_tpu/ops/freq.py:12-32).

The input, then for each of `n_freqs` log-spaced bands f = 2^0 .. 2^(n-1)
sin(f x) and cos(f x) over the whole input vector, interleaved per band
(the reference's FreqEncoder, tools/encoding.py:6-49).  Plain PyTorch: the
JAX package's encode is plain XLA with no hand-written VJP, so the port
has no kernel for it.
"""

from __future__ import annotations

import numpy as np
import torch


def freq_output_dim(input_dim: int, n_freqs: int,
                    include_input: bool = True) -> int:
    return (input_dim if include_input else 0) + input_dim * n_freqs * 2


def freq_bands(n_freqs: int, log_sampling: bool = True) -> np.ndarray:
    """The bands as float32, as the JAX package computes them."""
    max_freq_log2 = n_freqs - 1
    if log_sampling:
        return (2.0 ** np.linspace(0.0, max_freq_log2, n_freqs)).astype(
            np.float32)
    return np.linspace(1.0, 2.0 ** max_freq_log2, n_freqs).astype(np.float32)


def freq_encode(x, n_freqs: int, include_input: bool = True):
    """x: [..., D]. Returns [..., D * (1 + 2 * n_freqs)] (with the input)."""
    out = [x] if include_input else []
    for f in freq_bands(n_freqs):
        xf = x * float(f)
        out += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(out, dim=-1)
