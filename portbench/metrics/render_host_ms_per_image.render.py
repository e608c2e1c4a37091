"""Host ms per image inside the renderer (render/renderer.py render_rays):
the program's `render.*` spans (march, compaction, field, composite) of
every chunk render of the image, per image."""

from portbench.spans import ms_per_unit, prefixed


def read(ctx):
    return ms_per_unit(ctx, prefixed("render."))
