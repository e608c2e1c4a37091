"""Device ms per step of the AdamW update: the `torch._foreach_*`
kernels (`multi_tensor_apply`) of engine/optim.py."""

from portbench.readers import ops_ms, per_unit

PATTERN = r"multi_tensor_apply"


def read(ctx):
    return per_unit(ctx, ops_ms(ctx, PATTERN))
