"""The traced window's model FLOPs (portbench/flops.py: the heads' GEMMs,
the encodings' interpolation and the VM projection over valid samples)
against its seconds at the H100's dense bf16 peak, 989 TFLOP/s."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
