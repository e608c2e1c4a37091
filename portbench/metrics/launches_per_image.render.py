"""Device operations (kernels, copies, fills) in the traced window per
800x800 image."""

from portbench.readers import launches


def read(ctx):
    return launches(ctx)
