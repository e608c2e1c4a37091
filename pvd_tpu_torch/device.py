"""Device choice for the port's entry points.

Entry points (field constructors, `make_occ_update`, `make_eval_renderer`,
`init_occupancy_state`) run on the GPU unless the caller asks for the CPU.
There is no silent fallback: asking for CUDA on a machine without a GPU
raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point; raises if CUDA is asked for but
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pvd_tpu_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
