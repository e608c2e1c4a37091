"""What `run.py` reads: BENCHMARK.json, a cell's configuration and traffic
files, its driver, and the readers of its per-layer metrics, each found
by the name BENCHMARK.json gives it."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pvd_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic_of(cell: dict) -> dict:
    with open(BENCH_DIR / "traffic" / f"{cell['name']}.json") as f:
        return json.load(f)


def driver_of(traffic: dict):
    """The driver class named by the traffic file's `driver`."""
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return getattr(mod, traffic["driver_class"])


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The cell's end-to-end or per-layer metric entries."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    """The module portbench/metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (pvd_tpu_torch is not pvd_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def judge(checks: dict, limits: dict):
    """`correct` from the check's numbers: every number the traffic file
    gives a limit is present, finite and within it.  Returns (correct,
    {name: {"value", "limit"}})."""
    compared = {k: {"value": checks.get(k, math.nan), "limit": lim}
                for k, lim in limits.items()}
    correct = bool(compared) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    return correct, compared
