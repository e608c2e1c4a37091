#!/usr/bin/env python3
"""K1 (the hash encode forward, `pvd_hash_encode_fwd`) of this checkout
against another checkout's, in rotated rounds on one GPU.

    python3 tools/torch_k1_rounds.py --other build/parent [--rounds 10]

Builds both checkouts' kernel libraries (each into its own
`build/kernels/`), then at each shape times one K1 launch of each tree
per round (CUDA events, the median of 20 calls), the order of the trees
alternating from round to round, and prints one JSON line per shape: the
times of each tree, round by round, and each tree's max abs error against
the plain corner levels.  The shapes are the ones the paths launch K1 at,
on synthetic ray-major points (runs of 8-24 consecutive march steps of
random rays, `chip_smoke.march_runs`): the cell teacher's 65,536 points x
5 corner levels, the exact teacher's compacted 131,072 x 14 and the
serving chunk's 65,536 x 14.  The last line is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
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
from pvd_tpu_torch.ops import hashgrid  # noqa: E402
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec,  # noqa: E402
                                        corner_level_plain)

SHAPES = (("cell teacher", dict(n_cell_levels=9), 65536),
          ("exact teacher, compacted", {}, 131072),
          ("serving chunk", {}, 65536))


def other_kernels(root: Path):
    """The `pvd_tpu_torch/kernels.py` module of the checkout at `root`: it
    builds that checkout's library, and its entries take its own ctypes
    structs."""
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "pvd_tpu_torch" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = (("this", kernels), ("other", other_kernels(args.other)))
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    for name, kw, n in SHAPES:
        gs = HashGridSpec(**kw)
        x01 = torch.from_numpy(chip_smoke.march_runs(rng, n, 8, 24)).to(dev)
        table = torch.rand(gs.table_size, 2, device=dev) * 2 - 1
        lv = hashgrid._levels(gs, False)
        out = torch.zeros(n, gs.output_dim, device=dev)
        plain = torch.cat([corner_level_plain(table, x01, gs, level)
                           for level in gs.corner_levels], -1)
        cols = [c for level in gs.corner_levels
                for c in (2 * level, 2 * level + 1)]
        res = {"shape": name, "points": n, "levels": lv.n_levels,
               **{f"{tag}_ms": [] for tag, _ in libs},
               **{f"{tag}_err": 0.0 for tag, _ in libs}}
        for r in range(args.rounds):
            for tag, mod in (libs if r % 2 == 0 else libs[::-1]):
                def k1(lib=mod.load(),
                       lv_=mod.HashLevels.from_buffer_copy(lv)):
                    rc = lib.pvd_hash_encode_fwd(
                        x01.data_ptr(), table.data_ptr(), out.data_ptr(), n,
                        lv_, stream)
                    if rc != 0:
                        raise RuntimeError(f"K1 ({tag}): CUDA error {rc}")
                out.zero_()
                k1()
                res[f"{tag}_err"] = max(res[f"{tag}_err"], chip_smoke.max_abs(
                    out[:, cols], plain))
                res[f"{tag}_ms"].append(chip_smoke.cuda_ms(k1))
        print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
