"""Tracing and per-step timing (port of pvd_tpu/utils/profiling.py).

`trace(log_dir)` records what runs inside it with `torch.profiler` (the
host's ops, and the GPU's kernels and copies when CUDA is available) and
writes a Chrome trace, `<log_dir>/trace.json`, readable in Perfetto or
chrome://tracing; it does nothing when `log_dir` is falsy.  `StepTimer`
times named sections on the host's clock with the JAX package's summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block into `<log_dir>/trace.json`; a no-op when log_dir
    is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(value):
    """Wait until `value` is computed: a CUDA tensor synchronizes its
    device, anything else is read as a float (`.item()` for a tensor)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)
    else:
        float(value)


class StepTimer:
    """Wall-clock section timer with mean/p50/p95 summaries."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        """Time the block.  With a CUDA tensor as `sync_value` the time
        includes finishing all the block queued on its device; any other
        value is read as a float after the block."""
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            _sync(sync_value)
        self._samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per section: mean, p50 and p95 in ms over the samples after the
        first (the first call carries one-time costs: kernel builds and
        allocations; a single sample is kept), and the count of all."""
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs[1:] or xs)
            out[name] = {"mean_ms": float(a.mean() * 1e3),
                         "p50_ms": float(np.percentile(a, 50) * 1e3),
                         "p95_ms": float(np.percentile(a, 95) * 1e3),
                         "count": len(xs)}
        return out

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v['mean_ms']:.1f}ms (p95 {v['p95_ms']:.1f})"
            for k, v in self.summary().items())
