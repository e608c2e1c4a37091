"""Host ms per step of the Trainer's own loop (engine/trainer.py): the
window's wall less the program's `trainer.step` spans (the step
function's calls), per step.  What is left is the pixel draws, the
occupancy and clock ticks with their syncs, the history and log, and the
loop itself; and, weighed once an epoch of 312 steps (the traced window
runs 48 steps but holds an epoch's start and end), the epoch's poses
(`trainer.poses`) and its boundary (`trainer.epoch`)."""

from portbench.reference.poses import distill_epoch_poses
from portbench.spans import trainer_ms_per_step

# the steps of a distillation epoch: one a random pose
EPOCH_LEN = len(distill_epoch_poses(0))


def read(ctx):
    return trainer_ms_per_step(ctx, EPOCH_LEN)
