"""Color space (port of pvd_tpu/utils/misc.py:17-20): the teacher step's
`color_space="linear"` branch."""

from __future__ import annotations

import torch


def srgb_to_linear(x):
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
