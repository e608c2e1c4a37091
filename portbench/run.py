#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (everything before the window) makes the cell's inputs and weights
from the seed, builds the program's objects, and warms up the shapes the
window uses.  `--trace 0` measures the window for `--seconds` and reports
the cell's end-to-end metrics; `--trace 1` profiles a short window of the
traffic's `trace_steps` or `trace_images` and reports its per-layer
metrics.  Then the program's state is freed and the plain reference
checks what the timed path produced.  The last line of standard output is
one JSON object; the numbers compared, each with its limit, close
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# caches at fixed paths inside the checkout: only a cell's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host paces every cell
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.trace import CallLog, Tracer, instrument  # noqa: E402


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the GPU only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} needs {cell['chips']} GPUs, "
                    f"{torch.cuda.device_count()} present")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = harness.config_of(bench, cell)
    traffic = harness.traffic_of(cell)
    per_layer = harness.metrics_of(bench, cell["name"], "per_layer")
    readers = {m["name"]: harness.metric_reader(m["name"])
               for m in per_layer}
    calls = CallLog()
    if args.trace:
        instrument()
        for r in readers.values():
            for module, fn in getattr(r, "CALLS", ()):
                calls.watch(module, fn)

    workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        runner = harness.driver_of(traffic)(config, traffic, args.seed,
                                            "cuda", workdir)
        runner.setup()
        setup_s = time.perf_counter() - T_START
        print(f"portbench: set-up {setup_s:.3f} s", file=sys.stderr)
        if args.trace:
            tracer = Tracer()
            calls.on = True
            res = runner.trace_window(tracer)
            calls.on = False
        else:
            res = runner.window(args.seconds)
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(cell["chips"]))
        print(f"portbench: window {res['units']} {runner.unit}s in "
              f"{res['wall_s']:.3f} s, {res['valid_samples']:.0f} valid "
              f"samples, peak {peak / 2**30:.2f} GiB", file=sys.stderr)
        runner.release()
        metrics, extra = {}, {}
        if args.trace:
            red = tracer.reduce(res["wall_s"])
            print(f"portbench: trace {len(red.ops)} device ops, busy "
                  f"{red.busy_s:.4f} of {red.window_s:.4f} s, "
                  f"{red.in_spans:.3f} of device time inside host spans",
                  file=sys.stderr)
            ctx = dict(res, reduced=red, calls=calls.calls, config=config,
                       traffic=traffic, unit=runner.unit)
            for m in per_layer:
                v = readers[m["name"]].read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            calls.calls.clear()
            extra = {"busy_s": red.busy_s, "window_s": red.window_s}
            breakdown = {"device_ops": red.top_ops,
                         "idle_gaps": red.idle_gaps}
        else:
            rates = {"rays_per_s": res["work"] / res["wall_s"],
                     "ms_per_image": 1e3 * res["wall_s"] / max(res["units"],
                                                               1)}
            for m in harness.metrics_of(bench, cell["name"], "end_to_end"):
                if m["name"] == "setup_s":
                    metrics[m["name"]] = {"value": setup_s, "unit": "s"}
                else:
                    key = traffic["end_to_end"][m["name"]]
                    metrics[m["name"]] = {"value": rates[key],
                                          "unit": m["unit"]}
        t_check = time.perf_counter()
        checks = runner.check()
        print(f"portbench: check {time.perf_counter() - t_check:.3f} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    bad = harness.forbidden_modules()
    if bad:
        return fail("loaded JAX or the JAX package: " + ", ".join(bad), 3)
    correct, compared = harness.judge(checks, traffic["limits"])
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": int(res["units"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak), **extra}}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = compared
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
