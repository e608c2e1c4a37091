"""PSNR on the host (port of pvd_tpu/utils/metrics.py:19-38).

One scalar per image over the whole [H, W, 3] array, mean over images, as
the reference's PSNRMeter.  SSIM and LPIPS are not ported yet (ROADMAP
A11).
"""

from __future__ import annotations

from typing import List

import numpy as np


def psnr(pred, gt) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


class PSNRMeter:
    def __init__(self):
        self.psnr_list: List[float] = []

    def clear(self):
        self.psnr_list = []

    def update(self, preds, truths):
        self.psnr_list.append(psnr(preds, truths))

    def measure(self) -> float:
        return float(np.mean(self.psnr_list)) if self.psnr_list else 0.0

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"
