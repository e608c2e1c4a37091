"""Small helpers (port of pvd_tpu/utils/misc.py:11-26): seeding and the
sRGB <-> linear conversions (the teacher step's `color_space="linear"`).
The JAX package's `cpu_cache_key` and `setup_jax_cache_and_platform`
configure JAX itself (its compile cache and platform) and have no
PyTorch counterpart."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int):
    """Seed Python's, numpy's and torch's global generators (the JAX
    package seeds the first two; its device draws take explicit keys)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def srgb_to_linear(x):
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * x ** (1 / 2.4) - 0.055)
