"""K1 (csrc/hash_encode.cu, the corner levels' encode) against its
roofline: per call, bytes = x01 read (12 B a point) + the distinct table
rows its corners reach (8 B each) + the encoding written (8 B a point and
level); ops ~50 a point and level (lattice, 8 weights, 16 FMAs;
chip_smoke.py:4641).  The least time over the kernels' device time."""

from portbench.peaks import bound
from portbench.readers import hash_touched_rows, roofline
from portbench.reference.nerf import grid_of

CALLS = (("pvd_tpu_torch.ops.hashgrid", "hash_encode_fwd"),)
PATTERN = r"hash_encode_fwd_kernel|hash_encode_fwd_per_level_kernel"


def read(ctx):
    grid = grid_of(ctx["config"]["model"])
    L = grid.num_levels
    out = []
    for args, _ in ctx["calls"].get(
            "pvd_tpu_torch.ops.hashgrid.hash_encode_fwd", []):
        x01 = args[1]
        P = x01.shape[0]
        touched = hash_touched_rows(x01, grid)
        out.append(bound(P * 12 + touched * 8 + P * L * 8, P * L * 50)[0])
    return roofline(ctx, PATTERN, out)
