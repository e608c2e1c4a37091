"""Share of the traced window in which no operation ran on the device
(the union of the profiler's device intervals against the window)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
