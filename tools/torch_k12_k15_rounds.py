#!/usr/bin/env python3
"""K12 (the background's 2-D hash encode) and K15 (the baked dense levels'
encode) of this checkout against other designs, in rotated rounds on one
GPU.

    python3 tools/torch_k12_k15_rounds.py [--other build/parent] [--rounds 6]

Builds this checkout's kernel library, the designs of
`tools/k12_k15_candidates.cu` (a library of their own, beside it in
`build/`) and, with --other, the other checkout's library.  At each shape
it times one launch of every entry per round, the order rotating from
round to round: the kernel alone (the profiler's device time of 20
launches, the mean over the records it keeps) and the CUDA events' median
of 20 calls, and holds each entry's output to the plain version (max
|kernel - plain| / max |plain|) and to this tree's entry, bit for bit.  K1 at the cell teacher's 65,536 points x
5 corner levels (the first design's `encode_fwd<3>`, beside K12's body)
is timed in this tree and the other.  Prints one JSON line per shape and
entry (times round by round, the error) and, last, the card's name and
power limit.

The inputs are synthetic: K12 on the polar points of 4,096 random pixels
of a 512x512 view (a training batch's shape) and of the whole view
(262,144); K15 on a random table's bake at the A/B teacher's grid (side
73, 5 dense levels), at 24,576 and 65,536 ray-ordered points (runs of
consecutive march steps, `chip_smoke.march_runs`: a distill step's and an
eval chunk's) and 131,072 and 2,097,152 uniform random points.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pvd_tpu_torch import kernels  # noqa: E402
from pvd_tpu_torch.data.poses import pose_spherical  # noqa: E402
from pvd_tpu_torch.engine.train_steps import chunk_rays  # noqa: E402
from pvd_tpu_torch.models.api import bg_grid_spec  # noqa: E402
from pvd_tpu_torch.ops import hashgrid  # noqa: E402
from pvd_tpu_torch.ops.aabb import polar01_from_ray  # noqa: E402
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp  # noqa: E402

CANDIDATES = ROOT / "tools" / "k12_k15_candidates.cu"
# (label, variant, threads or points a block) of cand_k12 / cand_k15
K12_DESIGNS = (("(c) first design, 64 a block", 0, 64),
               ("(a) K1's body, 2 levels a thread", 1, 64),
               ("(b) a thread a point, 32 a block", 2, 32),
               ("(b) a thread a point, 64 a block", 2, 64),
               ("(b) a thread a point, 128 a block", 2, 128),
               ("(d) lean lanes, 256 a block", 3, 256),
               ("(d) lean lanes, 128 a block", 3, 128))
K15_DESIGNS = (("(a) corner lanes, 32 points a block", 0, 32),
               ("(a) corner lanes, 64 points a block", 0, 64),
               ("(b) level lanes, 32 points a block", 1, 32),
               ("(b) level lanes, 128 points a block", 1, 128))


def other_kernels(root: Path):
    """The `pvd_tpu_torch/kernels.py` module of the checkout at `root`: it
    builds that checkout's library, and its entries take its own ctypes
    structs."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "pvd_tpu_torch" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_candidates() -> ctypes.CDLL:
    """nvcc the candidates into their own shared library (the compiler's
    resource report printed)."""
    out = ROOT / "build" / "k12_k15_candidates" / "libcand.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(CANDIDATES),
           "-o", str(out)]
    p = subprocess.run(cmd, capture_output=True, text=True, check=False)
    for line in (p.stdout + p.stderr).splitlines():
        if "cand_" in line or "registers" in line or "error" in line:
            print("  nvcc " + line.strip(), flush=True)
    if p.returncode:
        raise RuntimeError(f"the candidates did not build ({p.returncode})")
    lib = ctypes.CDLL(str(out))
    for name in ("cand_k12", "cand_k15"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       kernels.HashLevels, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def alone_ms(fn, reps: int = 20) -> float:
    """Device time per launch of fn's kernels, from torch.profiler over reps
    calls after a warm-up (the mean over the launch records it keeps; a
    session that kept none is run again, up to 3 times)."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(reps):
            fn()

    for _ in range(4):
        top = chip_smoke.profile(run, top=4, cpu=False)["top"]
        calls = sum(r["calls"] for r in top)
        if calls:
            return sum(r["ms"] for r in top) / calls
    return float("nan")


def polar_points(dev, n_view: int = 512):
    """Polar points of a 512x512 view of the background sphere (radius 32)
    and of 4,096 random pixels of it."""
    pose = torch.as_tensor(nerf_matrix_to_ngp(pose_spherical(30.0, -30.0,
                                                             4.0)),
                           dtype=torch.float32, device=dev)
    f = 0.5 * n_view / np.tan(0.5 * 0.6911)
    o, d = chunk_rays(pose, (f, f, n_view / 2, n_view / 2), n_view, n_view,
                      0, n_view * n_view)
    view = polar01_from_ray(o, d, 32.0).contiguous()
    pick = torch.randperm(view.shape[0], device=dev)[:4096]
    return {"4096 batch": view[pick].contiguous(), "262144 view": view}


def entries(kind: str, libs: list, cand) -> list:
    """(label, call(x01, table, out, n, lv, stream)) of every entry of a
    kernel: the checkouts' shipped entries, then the candidates."""
    name = {"k12": "pvd_hash_encode2_fwd", "k15": "pvd_hash_baked_fwd",
            "k1": "pvd_hash_encode_fwd"}[kind]
    out = []
    for tag, mod in libs:
        lib = mod.load()

        def call(x, t, o, n, lv, s, fn=getattr(lib, name), mod=mod):
            return fn(x, t, o, n, mod.HashLevels.from_buffer_copy(lv), s)

        out.append((f"{tag} ({name})", call))
    if kind == "k1":
        return out
    designs = K12_DESIGNS if kind == "k12" else K15_DESIGNS
    fn = cand.cand_k12 if kind == "k12" else cand.cand_k15
    for label, variant, per in designs:
        def call(x, t, o, n, lv, s, variant=variant, per=per):
            return fn(variant, per, x, t, o, n, lv, s)

        out.append((label, call))
    return out


def rounds(kind, shape, x01, table, lv, plain, cols, out, calls, n_rounds,
           stream) -> None:
    """Time and check every entry on one input; print a line per entry."""
    n = x01.shape[0]
    res = {label: {"kernel": kind, "shape": shape, "points": n,
                   "entry": label, "alone_ms": [], "events_ms": [],
                   "err": 0.0, "bits_as_this": True} for label, _ in calls}
    first = {}
    scale = float(torch.nan_to_num(plain).abs().max())
    for r in range(n_rounds):
        k = r % len(calls)
        for label, call in calls[k:] + calls[:k]:
            def launch(call=call, label=label):
                rc = call(x01.data_ptr(), table.data_ptr(), out.data_ptr(),
                          n, lv, stream)
                if rc != 0:
                    raise RuntimeError(f"{kind} {label}: CUDA error {rc}")

            out.fill_(7.0)
            launch()
            torch.cuda.synchronize()
            got = out[:, cols].clone()
            err = chip_smoke.nan_abs(got, plain) / scale
            res[label]["err"] = max(res[label]["err"], err)
            # bit for bit this tree's output (calls[0], first in round 0)
            if label == calls[0][0]:
                first.setdefault("this", got)
            else:
                res[label]["bits_as_this"] &= torch.equal(
                    got.view(torch.int32), first["this"].view(torch.int32))
            res[label]["alone_ms"].append(alone_ms(launch))
            res[label]["events_ms"].append(chip_smoke.cuda_ms(launch))
    for v in res.values():
        v["alone_median_ms"] = float(np.nanmedian(v["alone_ms"]))
        print(json.dumps(v), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout to time beside this one")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    libs = [("this", kernels)]
    if args.other is not None:
        libs.append(("other", other_kernels(args.other)))
    cand = build_candidates()
    stream = torch.cuda.current_stream().cuda_stream

    gs = bg_grid_spec()
    table = torch.rand(gs.table_size, 2, device=dev) * 2 - 1
    lv = hashgrid._levels(gs, False)
    calls = entries("k12", libs, cand)
    for shape, x01 in polar_points(dev).items():
        out = torch.empty(x01.shape[0], gs.output_dim, device=dev)
        plain = hashgrid.hash_encode_plain(table, x01, gs)
        rounds("k12", shape, x01, table, lv, plain, list(range(8)), out,
               calls, args.rounds, stream)

    gs = hashgrid.HashGridSpec(n_cell_levels=9)
    table = torch.rand(gs.table_size, 2, device=dev) * 2 - 1
    baked = hashgrid.build_baked_dense(table, gs)
    lv = hashgrid._baked_levels(gs)
    cols = [2 * level + c for level in gs.dense_levels for c in (0, 1)]
    calls = entries("k15", libs, cand)
    for shape, x01 in (
            ("24576 ray-ordered", chip_smoke.march_runs(rng, 24576, 2, 12)),
            ("65536 ray-ordered", chip_smoke.march_runs(rng, 65536, 4, 24)),
            ("131072 uniform", rng.uniform(0, 1, (131072, 3))),
            ("2097152 uniform", rng.uniform(0, 1, (2097152, 3)))):
        x01 = torch.from_numpy(np.asarray(x01, np.float32)).to(dev)
        out = torch.empty(x01.shape[0], gs.output_dim, device=dev)
        plain = hashgrid.hash_encode_baked_plain(baked, x01, gs)
        rounds("k15", shape, x01, baked, lv, plain, cols, out, calls,
               args.rounds, stream)

    # K1 on at most 8 levels (the cell teacher's 5 corner levels), the
    # first design's body, beside K12's
    lv = hashgrid._levels(gs, False)
    x01 = torch.from_numpy(chip_smoke.march_runs(rng, 65536, 8, 24)).to(dev)
    out = torch.empty(x01.shape[0], gs.output_dim, device=dev)
    plain = torch.cat([hashgrid.corner_level_plain(table, x01, gs, level)
                       for level in gs.corner_levels], -1)
    cols = [2 * level + c for level in gs.corner_levels for c in (0, 1)]
    rounds("k1", "65536 x 5 corner levels", x01, table, lv, plain, cols, out,
           entries("k1", libs, cand), args.rounds, stream)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
