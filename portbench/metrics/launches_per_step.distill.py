"""Device operations (kernels, copies, fills) in the traced window per
step: what a host-bound step pays for in launches."""

from portbench.readers import launches


def read(ctx):
    return launches(ctx)
