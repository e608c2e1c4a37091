"""K5 (csrc/vm_sample.cu, the VM planes' and lines' gradient by float
atomics) against its roofline: per call, bytes = xn (12 B a sample) and
the upstream gradient (3 x R x 4 B a sample) read once, and each
distinct plane and line row the valid samples' taps reach read and
written once (2 x R x 4 B); ops ~26 a valid (sample, branch, channel)
(chip_smoke.py:1106).  The gradient buffers' zero fill is a separate
operation and is left out of both sides."""

from portbench.peaks import bound
from portbench.readers import roofline, vm_touched_rows

CALLS = (("pvd_tpu_torch.ops.vm_sample", "vm_sample_bwd"),)
PATTERN = r"vm_sample_bwd_kernel"


def read(ctx):
    out = []
    for args, _ in ctx["calls"].get(
            "pvd_tpu_torch.ops.vm_sample.vm_sample_bwd", []):
        planes, lines, xn, g = args[:4]
        M, R = xn.shape[0], planes[0].shape[-1]
        live = (g != 0).any(-1).any(0)
        n_valid = int(live.sum())
        touched = vm_touched_rows(planes, lines, xn[live])
        out.append(bound(M * 12 + 3 * M * R * 4 + touched * R * 8,
                         3 * n_valid * R * 26)[0])
    return roofline(ctx, PATTERN, out)
