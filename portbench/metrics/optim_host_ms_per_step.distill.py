"""Host ms per step of the backward and the optimizer
(engine/train_steps.py _adamw_step, engine/optim.py): the program's
`step.backward`, `step.adamw` and `step.ema` spans, per step."""

from portbench.spans import ms_per_unit, named


def read(ctx):
    return ms_per_unit(ctx, named("step.backward", "step.adamw",
                                  "step.ema"))
