"""Chunk renders per image dispatched by the eval renderer's budget
ladder (engine/train_steps.py make_eval_renderer): the program's
`eval.chunk_renders.r1`, `.r2` and `.r3` counters summed, per image."""

from portbench.spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "eval.chunk_renders.")
