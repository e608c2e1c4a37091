"""Host ms per step inside the renderer (render/renderer.py render_rays):
the program's `render.*` spans (march, compaction, field, composite,
background) of the student's render and the teacher's replay, per
step."""

from portbench.spans import ms_per_unit, prefixed


def read(ctx):
    return ms_per_unit(ctx, prefixed("render."))
