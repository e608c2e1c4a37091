#!/usr/bin/env python3
"""The readings that a cell's limits are set from, several seeds in one
process (set-up is most of a run's time):

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--images 2]

For each seed: the cell's set-up (a training cell stops after the
recorded first steps, which are all the check reads), for the render cell
a window of `--images` images, then the check of the
program against the reference and the check of the control (the
reference in bfloat16 put in the program's place) against it.  With
`--fault` a fault (portbench/faults.py) is planted in the program first
and only the program's check runs.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--fault", choices=faults.FAULTS,
                    help="plant a fault in the program first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    config = harness.config_of(bench, cell)
    traffic = harness.traffic_of(cell)
    render = traffic["driver"] == "render"
    if render:
        traffic = dict(traffic, trace_images=args.images)
    else:
        # the check reads the recorded first steps alone
        traffic = dict(traffic, setup_steps=traffic["check_steps"])
    if args.fault:
        faults.plant(args.fault, "render" if render else traffic["mode"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="portbench_")
        runner = harness.driver_of(traffic)(config, traffic, seed, "cuda",
                                            workdir)
        runner.setup()
        if render:
            runner.trace_window()
        runner.release()
        out = {"seed": seed, "fault": args.fault,
               "program": runner.check()}
        if not args.fault:
            out["control"] = runner.check(control=True)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del runner
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
