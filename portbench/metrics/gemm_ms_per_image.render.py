"""Device ms per image of cuBLAS GEMM kernels: the heads' bf16 layers."""

from portbench.readers import ops_ms, per_unit

PATTERN = r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce|Kernel2"


def read(ctx):
    return per_unit(ctx, ops_ms(ctx, PATTERN))
