"""PSNR and SSIM on the host (port of pvd_tpu/utils/metrics.py:19-89).

PSNR: one scalar per image over the whole [H, W, 3] array, mean over
images, as the reference's PSNRMeter.  SSIM: the tf.image.ssim
formulation (separable 11x11 Gaussian, sigma 1.5, k1 0.01, k2 0.03) in
float64 numpy, as the JAX package computes it.  `lpips_proxy` is the JAX
package's random-feature stand-in for LPIPS (metrics.py:125-180), which it
reports when the lpips package's pretrained weights are missing, as they
are on both machines; real LPIPS is not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


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


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution over H and W of [H, W, C]."""
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(img, len(k), axis=0)  # [H-10, W, C, 11]
    out = np.tensordot(win, k, axes=([-1], [0]))
    win = sliding_window_view(out, len(k), axis=1)
    return np.tensordot(win, k, axes=([-1], [0]))


def compute_ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
                 filter_sigma: float = 1.5, k1: float = 0.01,
                 k2: float = 0.03) -> float:
    """Mean SSIM over an [H, W, C] pair in [0, max_val]."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    k = _gaussian_kernel(filter_size, filter_sigma)
    mu0 = _filter2_sep(img0, k)
    mu1 = _filter2_sep(img1, k)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2_sep(img0 * img0, k) - mu00
    s11 = _filter2_sep(img1 * img1, k) - mu11
    s01 = _filter2_sep(img0 * img1, k) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2)) / (
        (mu00 + mu11 + c1) * (s00 + s11 + c2))
    return float(np.mean(ssim_map))


_PROXY_FILTERS = None


def _proxy_filters():
    """Fixed-seed random conv stacks of the perceptual proxy: 3 scales x 24
    channels of 5x5 filters, seed 1789 (metrics.py:125-143)."""
    global _PROXY_FILTERS
    if _PROXY_FILTERS is None:
        rng = np.random.default_rng(1789)
        _PROXY_FILTERS = [
            (rng.standard_normal((24, 3, 5, 5)) / np.sqrt(75.0)).astype(
                np.float32)
            for _ in range(3)
        ]
    return _PROXY_FILTERS


def lpips_proxy(pred, gt) -> float:
    """Perceptual distance proxy, NOT the reference's LPIPS: multi-scale
    random-conv feature maps of [H, W, 3] images in [0, 1],
    channel-normalised like LPIPS, mean squared feature difference summed
    over 3 dyadic scales (metrics.py:146-180).  Comparable only with
    itself (lower = closer)."""
    def prep(x):
        t = torch.from_numpy(np.asarray(x, np.float32)).permute(2, 0, 1)[None]
        return t * 2.0 - 1.0

    a, b = prep(pred), prep(gt)
    total = 0.0
    with torch.no_grad():
        for w in _proxy_filters():
            wt = torch.from_numpy(w)
            fa = F.conv2d(a, wt, padding=2)
            fb = F.conv2d(b, wt, padding=2)
            fa = fa / (fa.norm(dim=1, keepdim=True) + 1e-10)
            fb = fb / (fb.norm(dim=1, keepdim=True) + 1e-10)
            total += float(((fa - fb) ** 2).sum(dim=1).mean())
            a = F.avg_pool2d(a, 2)
            b = F.avg_pool2d(b, 2)
    return total
