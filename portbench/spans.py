"""Arithmetic the readers of the program's own spans and counters share.

The program (`pvd_tpu_torch/utils/profiling.py`) records its spans (name,
start ns, end ns, parent index, unit) and counters while a profiler
session is open, which in a traced run is the benchmark's session around
the window.  A reader counts the spans that start inside the window, the
rule `Tracer.reduce` applies to device operations, each up to the
window's end.  The window starts at
the first host span of the window, the benchmark's (`trace.SPANS`) or the
program's, which both drivers open as soon as the window's clock starts,
and lasts the window's wall.  The counters are the session's totals: the
session holds the window and no other call of the program.

A program without the recorder (an older commit) gives None: the reader
then reports nothing.
"""

from __future__ import annotations

from portbench.trace import SPANS


def program():
    """(spans, counters) of the program's last profiler session, or None
    when the program records none."""
    try:
        from pvd_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    counters = getattr(profiling, "counters", None)
    if records is None or counters is None:
        return None
    spans = records()
    return (spans, counters()) if spans else None


def window(ctx, spans) -> tuple:
    """(start ns, end ns) of the traced window."""
    t0 = min([s[0] for s in SPANS.records] + [s[1] for s in spans])
    return t0, t0 + int(ctx["wall_s"] * 1e9)


def durations(ctx, match) -> list | None:
    """ns of each of the window's spans whose name `match` accepts, up to
    the window's end, each time counted once: a span inside another
    accepted span is left to it.  None when the program records no
    spans."""
    got = program()
    if got is None:
        return None
    spans, _ = got
    t0, t1 = window(ctx, spans)

    def inside(i):
        while i is not None:
            if match(spans[i][0]):
                return True
            i = spans[i][3]
        return False

    return [min(end, t1) - start for name, start, end, parent, _ in spans
            if end is not None and t0 <= start <= t1
            and match(name) and not inside(parent)]


def span_ns(ctx, match) -> float | None:
    """Summed ns of the window's spans whose name `match` accepts
    (`durations`); None when the program records no spans."""
    d = durations(ctx, match)
    return None if d is None else float(sum(d))


def ms_per_unit(ctx, match) -> float | None:
    """`span_ns` in ms per unit of work (step or image)."""
    ns = span_ns(ctx, match)
    if ns is None or not ctx["units"]:
        return None
    return ns / 1e6 / ctx["units"]


def named(*names):
    """A match of these names exactly."""
    names = set(names)
    return names.__contains__


def prefixed(prefix: str):
    """A match of the names that start with `prefix`."""
    return lambda name: name.startswith(prefix)


# the Trainer's spans that a distillation epoch pays once, whatever its
# length: its poses, drawn and uploaded, and its boundary
EPOCH_SPANS = ("trainer.poses", "trainer.epoch")


def trainer_ms_per_step(ctx, epoch_len: int) -> float | None:
    """Host ms per step of the Trainer's own loop: the window's wall less
    its `trainer.step` spans and its once-an-epoch spans, per step, plus
    each once-an-epoch span's mean over the `epoch_len` steps of an epoch.
    A short traced window holds an epoch's start and end however few
    steps it runs; so weighed, they count as in a window of whole
    epochs."""
    steps = durations(ctx, named("trainer.step"))
    if not steps or not ctx["units"]:
        return None
    loop = ctx["wall_s"] * 1e9 - sum(steps)
    per_epoch = 0.0
    for name in EPOCH_SPANS:
        d = durations(ctx, named(name))
        loop -= sum(d)
        if d:
            per_epoch += sum(d) / len(d)
    return (loop / ctx["units"] + per_epoch / epoch_len) / 1e6


def counter_per_unit(ctx, prefix: str) -> float | None:
    """The session's counters whose names start with `prefix`, summed, per
    unit; None without the program's counters or without such a
    counter."""
    got = program()
    if got is None or not ctx["units"]:
        return None
    hits = [v for k, v in got[1].items() if k.startswith(prefix)]
    return sum(hits) / ctx["units"] if hits else None
