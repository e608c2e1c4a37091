"""pvd_tpu_torch's tracing and step timer (`utils/profiling.py`) on the
CPU: StepTimer's summary against the JAX package's on the same samples
(exact), and `trace` writing a Chrome trace of what ran inside it."""

import json
import os
import time

import numpy as np
import pytest
import torch

from pvd_tpu.utils.profiling import StepTimer as JStepTimer
from pvd_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(1)


@pytest.mark.parametrize("samples", [[0.5], [0.9, 0.01, 0.02, 0.04],
                                     list(np.linspace(0.001, 0.02, 37))])
def test_step_timer_summary_matches_jax(samples):
    """The first sample (compile or build) is dropped unless it is the
    only one; mean, p50 and p95 in ms; count of all samples."""
    ours, theirs = StepTimer(), JStepTimer()
    for t in (ours, theirs):
        t._samples["step"].extend(samples)
        t._samples["eval"].extend(samples[::-1])
    assert ours.summary() == theirs.summary()
    assert ours.report() == theirs.report()
    s = ours.summary()["step"]
    assert s["count"] == len(samples)
    rest = samples[1:] or samples
    assert s["mean_ms"] == pytest.approx(np.mean(rest) * 1e3)


def test_step_timer_sections_time_the_block():
    timer = StepTimer()
    for _ in range(3):
        with timer.section("sleep", sync_value=torch.ones(()).sum()):
            time.sleep(0.01)
    s = timer.summary()["sleep"]
    assert s["count"] == 3 and 9.0 <= s["p50_ms"] < 200.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    a = torch.rand(64, 64)
    with trace(log_dir):
        (a @ a).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_without_a_directory_does_nothing(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for off in (None, ""):
            with trace(off):
                torch.ones(3).sum()
        assert os.listdir(tmp_path) == []
    finally:
        os.chdir(cwd)
