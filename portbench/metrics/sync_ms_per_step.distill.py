"""Host ms per step spent waiting on the device: the program's `sync`
spans (utils/profiling.sync and readback: the Trainer's phase clock,
ticks, log reads and epoch end), per step."""

from portbench.spans import ms_per_unit, named


def read(ctx):
    return ms_per_unit(ctx, named("sync"))
