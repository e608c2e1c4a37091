#!/usr/bin/env python3
"""Which kernel records does torch.profiler keep on the GPU, in a fresh
process and after a long profiled session?  Launches K1 and K10 (the
port's `hash_encode_fwd` on a cell-mode grid, 2,097,152 points) between
launches of an aten multiply, in short profiler sessions, and prints one
JSON line per stage: each session's device kernel records in time order,
one letter a record (m: the multiply, a: K1, c: K10).  A session that kept
every record reads "macm...m".  Stages: a fresh process; after one session
of ~46,000 small kernels (a profiled 800x800 render holds as many); after
30 more sessions of 20 K1 launches each.  The cases of each stage: 12
launches; 1 launch; 1 launch 50 ms after the profiler starts; 1 launch
after 20 multiplies.

    python3 tools/torch_profiler_record_loss.py

Needs a CUDA GPU and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pvd_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode_fwd  # noqa

ACTIVITIES = {"cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
              "cuda": [ProfilerActivity.CUDA]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    spec = HashGridSpec(num_levels=16, n_cell_levels=4)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand(spec.table_size, 2, device=dev, generator=g) * 1e-2
    cell = torch.rand(spec.cell_table_size, spec.cell_row_width,
                      device=dev, generator=g) * 1e-2
    x = torch.rand(2 ** 21, 3, device=dev, generator=g)
    y = torch.empty_like(x)

    def encode():
        hash_encode_fwd(table, x, spec, cell)

    def records(reps, acts, pause=0.0, lead=0) -> str:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(pause)
            for _ in range(lead):
                torch.mul(x, 3.0, out=y)
            for _ in range(reps):
                torch.mul(x, 2.0, out=y)
                encode()
            torch.mul(x, 2.0, out=y)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kept = sorted((e["ts"], e["name"]) for e in events
                      if e.get("cat") == "kernel")
        return "".join("a" if "hash_encode_fwd" in n
                       else "c" if "hash_cell_fwd" in n
                       else "m" if "ul" in n else "." for _, n in kept)

    def stage(name: str):
        out = {}
        for an, acts in ACTIVITIES.items():
            out[an] = {"launches12": [records(12, acts) for _ in range(4)],
                       "single": [records(1, acts) for _ in range(8)],
                       "pause50ms": [records(1, acts, pause=0.05)
                                     for _ in range(4)],
                       "lead20": [records(1, acts, lead=20)
                                  for _ in range(4)]}
        print(json.dumps({"stage": name, "records": out}), flush=True)

    encode()
    torch.cuda.synchronize()
    stage("fresh")
    small = torch.rand(4096, 64, device=dev)
    with profile(activities=ACTIVITIES["cpu+cuda"]) as prof:
        for i in range(15000):
            small.mul_(1.0)
            small.add_(0.0)
            small.relu_()
            if i % 32 == 0:
                hash_encode_fwd(table, x[:4096], spec, cell)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    print(json.dumps({"long_session_device_records": n}), flush=True)
    stage("after a long session")
    for _ in range(30):
        with profile(activities=ACTIVITIES["cuda"]) as prof:
            for _ in range(20):
                encode()
            torch.cuda.synchronize()
        prof.key_averages()
    stage("after 30 more sessions")
    print(f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
