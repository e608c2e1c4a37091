"""Host ms per image spent waiting on the device in the eval renderer
(engine/train_steps.py make_eval_renderer): the program's `sync` spans,
a readback of the truncation flags each rung and the valid samples' read,
per image."""

from portbench.spans import ms_per_unit, named


def read(ctx):
    return ms_per_unit(ctx, named("sync"))
