"""On the card: each cell of BENCHMARK.json runs end to end through
run.py (a short window), prints one result line with every key the
contract reads, and comes out correct.  Skips without a GPU."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.metrics_of(
        harness.load_benchmark(), cell, kind)}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
