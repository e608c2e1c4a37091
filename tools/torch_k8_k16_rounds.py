#!/usr/bin/env python3
"""K8 (the padded composite's forward) and K16 (the bake of a frozen table)
of this checkout against other designs, in rotated rounds on one GPU.

    python3 tools/torch_k8_k16_rounds.py [--other build/parent] [--rounds 6]

Builds this checkout's kernel library, the designs of
`tools/k8_k16_candidates.cu` (a library of their own, beside it in
`build/`; it also holds the first designs of K8 and K16) and, with
--other, the other checkout's library.  At each shape it times one launch
of every entry per round, the order rotating from round to round: the
kernel alone (the profiler's device time of 20 launches, the mean over the
records it keeps) and the CUDA events' median of 20 calls.  It holds every
entry's K8 weights and K16 table to the first design's bit for bit, K8's
per-ray sums to the plain version (max |kernel - plain|, the tolerance
`chip_smoke.TOL_K8`) and K16's table to the plain version bit for bit.
Prints one JSON line per shape and entry (times round by round, the
checks) and, last, the card's name and power limit; exits 1 when a check
fails.

The inputs are synthetic, shaped as the trained teachers' padded warm-up
batches that `chip_smoke.py` logs (`k9_rows`): [8192, 96] with ~1,090 rows
holding a valid prefix of 48-96 slots (the exact teacher), [4096, 96] with
~570 rows of 56-96 (the A/B teacher), [4096, 64] with ~3,780 rows of
4-64 (the large scene), and [8192, 96] with prefixes of 0-20 slots; the
exact teacher's also with early stop.  K16 bakes a random table at bound
1 (the A/B teacher's grid: side 73, 5 dense levels) and bound 2 (side 59,
4 levels).
"""

from __future__ import annotations

import argparse
import ctypes
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
from tools.torch_k12_k15_rounds import alone_ms, other_kernels  # noqa: E402
from pvd_tpu_torch.ops import hashgrid  # noqa: E402
from pvd_tpu_torch.ops.composite import composite_rays_plain  # noqa: E402

CANDIDATES = ROOT / "tools" / "k8_k16_candidates.cu"
FIRST = "first design"
# (label, variant) of cand_k8; (label, variant, threads) of cand_k16
K8_DESIGNS = ((FIRST, 0), ("a warp a ray, a tile's loads at a time", 1),
              ("16 lanes a ray, 96 slots' loads together", 2),
              ("16 lanes a ray, a tile's loads at a time", 3),
              ("2 tiles' loads together", 4))
K16_DESIGNS = ((FIRST, 0, 256), ("(b) 3-D grid, (Ld, 32) a block", 1, 32),
               ("(b) 3-D grid, (Ld, 64) a block", 1, 64),
               *((f"(a) a block a row, {th} threads", 2, th)
                 for th in (64, 256)),
               *((f"(a), {u} entries' loads at once, {th} threads", 1 + u,
                  th) for th in (64, 128) for u in (2, 3)),
               *((f"(c) coarse lines in shared memory, {th} threads", 5, th)
                 for th in (64, 128)))
# (shape, N, S, rows with a valid prefix, its shortest and longest length)
K8_SHAPES = (("[8192, 96] exact teacher", 8192, 96, 1090, 48, 96),
             ("[4096, 96] A/B teacher", 4096, 96, 570, 56, 96),
             ("[4096, 64] large scene", 4096, 64, 3780, 4, 64),
             ("[8192, 96] prefixes of 0-20", 8192, 96, 8192, 0, 20))


def build_candidates() -> ctypes.CDLL:
    """nvcc the candidates into their own shared library (the compiler's
    resource report printed)."""
    out = ROOT / "build" / "k8_k16_candidates" / "libcand.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(CANDIDATES),
           "-o", str(out)]
    p = subprocess.run(cmd, capture_output=True, text=True, check=False)
    for line in (p.stdout + p.stderr).splitlines():
        if any(k in line for k in ("k8", "k16", "bake", "composite_padded",
                                   "registers", "error")):
            print("  nvcc " + line.strip(), flush=True)
    if p.returncode:
        raise RuntimeError(f"the candidates did not build ({p.returncode})")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cand_k8.argtypes = [I, P, P, P, P, P, I, I, I, P, P, P, P, P]
    lib.cand_k16.argtypes = [I, I, P, P, P, P, I, kernels.HashLevels, P]
    lib.cand_k8.restype = lib.cand_k16.restype = I
    return lib


def k8_batch(rng, dev, N, S, rows, lo, hi):
    """A padded batch [N, S]: `rows` random rows hold a valid prefix of
    lo-hi slots, the rest none; densities of a trained field's range."""
    lens = np.zeros(N, np.int64)
    pick = rng.choice(N, rows, replace=False)
    lens[pick] = rng.integers(lo, hi + 1, rows)
    mask = np.arange(S)[None] < lens[:, None]
    sig = rng.choice([0.0, 0.5, 3.0, 20.0, 80.0, 400.0], size=(N, S))
    sig = (sig * rng.uniform(0.5, 1.5, (N, S))).astype(np.float32)
    dt = np.full((N, S), 2 * np.sqrt(3) / 1024, np.float32)
    dd = (dt * rng.uniform(0.8, 1.2, (N, S))).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (sig, rgb, dt, dd, mask)]


def k8_entries(libs, cand) -> list:
    """(label, call(args, early, outs, stream)) of every K8 entry."""
    out = []
    for tag, mod in libs:
        fn = getattr(mod.load(), "pvd_composite_padded_fwd")
        out.append((f"{tag} (pvd_composite_padded_fwd)",
                    lambda a, e, o, s, fn=fn: fn(*a[:5], *a[5:], e, *o, s)))
    for label, variant in K8_DESIGNS:
        out.append((label, lambda a, e, o, s, v=variant:
                    cand.cand_k8(v, *a[:5], *a[5:], e, *o, s)))
    return out


def k16_entries(libs, cand) -> list:
    """(label, call(table, b, f, baked, side, lv, stream)) of every K16
    entry."""
    out = []
    for tag, mod in libs:
        fn = getattr(mod.load(), "pvd_hash_bake")
        out.append((f"{tag} (pvd_hash_bake)",
                    lambda t, b, f, o, sd, lv, s, fn=fn, mod=mod: fn(
                        t, b, f, o, sd, mod.HashLevels.from_buffer_copy(lv),
                        s)))
    for label, variant, threads in K16_DESIGNS:
        out.append((label, lambda t, b, f, o, sd, lv, s, v=variant,
                    th=threads: cand.cand_k16(v, th, t, b, f, o, sd, lv, s)))
    return out


def rounds(kind, shape, calls, launch_of, outputs, check, n_rounds) -> bool:
    """Time and check every entry on one input; print a line per entry.
    launch_of(call) launches one entry into `outputs` (filled with NaN
    before each checked launch); check(label, got, first) -> dict of the
    entry's checks (each a bool or an error), got and first the outputs'
    copies of this entry and of the first design."""
    res = {label: {"kernel": kind, "shape": shape, "entry": label,
                   "alone_ms": [], "events_ms": []} for label, _ in calls}
    seen = {}
    for r in range(n_rounds):
        k = r % len(calls)
        for label, call in calls[k:] + calls[:k]:
            def launch(call=call, label=label):
                rc = launch_of(call)
                if rc != 0:
                    raise RuntimeError(f"{kind} {label}: CUDA error {rc}")

            for o in outputs:
                o.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            seen[label] = [o.clone() for o in outputs]
            res[label]["alone_ms"].append(alone_ms(launch))
            res[label]["events_ms"].append(chip_smoke.cuda_ms(launch))
    ok = True
    for label, v in res.items():
        v.update(check(label, seen[label], seen[FIRST]))
        ok &= all(x is True or (not isinstance(x, bool) and x <= v["tol"])
                  for k, x in v.items() if k.startswith("ok_")
                  or k == "err")
        v["alone_median_ms"] = float(np.nanmedian(v["alone_ms"]))
        print(json.dumps(v), flush=True)
    return ok


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
    rng = np.random.default_rng(args.seed)
    libs = [("this", kernels)]
    if args.other is not None:
        libs.append(("other", other_kernels(args.other)))
    cand = build_candidates()
    stream = torch.cuda.current_stream().cuda_stream
    ok = True

    calls = k8_entries(libs, cand)
    for shape, N, S, n_rows, lo, hi in K8_SHAPES:
        sig, rgb, dt, dd, mask = k8_batch(rng, dev, N, S, n_rows, lo, hi)
        outs = [torch.empty(N, S, device=dev), torch.empty(N, device=dev),
                torch.empty(N, device=dev), torch.empty(N, 3, device=dev)]
        ptrs = [t.data_ptr() for t in (sig, rgb, dt, dd, mask)] + [N, S]
        optr = [o.data_ptr() for o in outs]
        for early in ((0, 1) if shape.endswith("exact teacher") else (0,)):
            plain = composite_rays_plain(sig, rgb, dt, dd, mask, bool(early))

            def check(label, got, first, plain=plain):
                w = got[0]
                sums = max(chip_smoke.max_abs(a, b) for a, b in
                           zip(got[1:], plain[:3]))
                return {"valid": int(mask.sum()), "early_stop": bool(early),
                        "ok_weights_as_first": torch.equal(
                            w.view(torch.int32), first[0].view(torch.int32)),
                        "err": max(sums, chip_smoke.max_abs(w, plain[3])),
                        "tol": chip_smoke.TOL_K8}

            ok &= rounds("k8", shape + (", early stop" if early else ""),
                         calls, lambda c, e=early: c(ptrs, e, optr, stream),
                         outs, check, args.rounds)

    calls = k16_entries(libs, cand)
    for shape, gs in (("bound 1: side 73, 5 dense levels",
                       hashgrid.HashGridSpec(n_cell_levels=9)),
                      ("bound 2: side 59, 4 dense levels",
                       hashgrid.HashGridSpec(desired_resolution=4096,
                                             n_cell_levels=9))):
        table = torch.rand(gs.table_size, 2, device=dev) * 2 - 1
        side = gs.level_side(gs.dense_levels[-1])
        b, f = hashgrid._bake_axes_on(gs, dev)
        lv = hashgrid._bake_levels(gs)
        out = torch.empty(side ** 3, 2 * lv.n_levels, device=dev)
        plain = hashgrid.build_baked_dense_plain(table, gs)

        def check(label, got, first, plain=plain):
            return {"ok_bits_as_first": torch.equal(
                        got[0].view(torch.int32), first[0].view(torch.int32)),
                    "ok_bits_as_plain": torch.equal(
                        got[0].view(torch.int32), plain.view(torch.int32)),
                    "tol": 0.0}

        ok &= rounds("k16", shape, calls, lambda c: c(
            table.data_ptr(), b.data_ptr(), f.data_ptr(), out.data_ptr(),
            side, lv, stream), [out], check, args.rounds)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    if not ok:
        print("a design disagrees (see the ok_ and err fields)",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
