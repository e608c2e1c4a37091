"""Device ms per step of cuBLAS GEMM kernels: the heads' bf16 layers and,
in distillation, the VM projection's float32 bmm, forward and backward."""

from portbench.readers import ops_ms, per_unit

PATTERN = r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce|Kernel2"


def read(ctx):
    return per_unit(ctx, ops_ms(ctx, PATTERN))
