"""The traced window: one `torch.profiler` session of the device's
kernels, copies and fills, the benchmark's own host spans around the
calls into the program's layers (`span`, `instrument`), and the arguments
of the program functions that a per-layer metric asks for (`CallLog`).
`reduce` turns the session into device intervals, the busy time (the
union of the device's intervals), the device operations by time and the
idle gaps by the innermost host span at each gap.

The profiler records the device alone: with the host's ops recorded too,
a distillation step took 13x as long and an occupancy update 400x, which
leaves nothing of the window to measure.  The host spans are taken on the
wall clock in ns, the profiler's own time base.  One session per
process: after a session of ~46,000 kernels the profiler drops records of
later sessions (tools/torch_profiler_record_loss.py).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "portbench."


class _Spans:
    """Host spans (name, start ns, end ns), recorded while `on`."""

    def __init__(self):
        self.on = False
        self.records = []


SPANS = _Spans()


@contextlib.contextmanager
def span(name: str):
    """Record the block as a host span while the traced window is on."""
    if not SPANS.on:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        SPANS.records.append((t0, time.time_ns(), SPAN_PREFIX + name))


def _spanned(name: str, fn):
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped


def instrument():
    """Host spans around the program's layers, for the traced window: the
    render (march, compaction, field, composite), the backward and
    AdamW."""
    from pvd_tpu_torch.engine import train_steps
    for name, owner, attr in (("render_rays", train_steps, "render_rays"),
                              ("backward_adamw", train_steps, "_adamw_step")):
        fn = getattr(owner, attr)
        if not hasattr(fn, "__wrapped__"):
            setattr(owner, attr, _spanned(name, fn))


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel | memcpy | memset
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Reduced:
    ops: list  # DeviceOp, in start order
    busy_s: float
    window_s: float
    top_ops: list  # [name, seconds], at most 10
    idle_gaps: list  # [host label, seconds], at most 10
    in_spans: float  # share of device time starting inside a host span


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class Tracer:
    """start() opens the profiler session (which takes seconds, so before
    the window); begin() and end() mark the window (each synchronises the
    device first); stop() closes the session.  Only device operations that
    start inside the window count."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()

    def begin(self):
        torch.cuda.synchronize()
        SPANS.records.clear()
        SPANS.on = True
        self.t0_ns = time.time_ns()

    def end(self):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        SPANS.on = False

    def stop(self):
        torch.cuda.synchronize()
        SPANS.on = False
        self.prof.stop()

    def reduce(self, window_s: float) -> Reduced:
        dev = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA") and \
                    self.t0_ns <= e.start_ns() <= self.t1_ns:
                dev.append(DeviceOp(e.name(), _kind(e.name()), e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
        host = list(SPANS.records)
        dev.sort(key=lambda o: o.start_ns)
        merged = []
        for o in dev:
            if merged and o.start_ns <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end_ns)
            else:
                merged.append([o.start_ns, o.end_ns])
        busy_s = sum(b - a for a, b in merged) / 1e9
        by_name = defaultdict(float)
        for o in dev:
            by_name[o.name[:160]] += (o.end_ns - o.start_ns) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        union = []
        for a, b, _ in sorted(host):
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        heads = [u[0] for u in union]

        def covered(t):
            k = bisect.bisect_right(heads, t) - 1
            return k >= 0 and t <= union[k][1]

        inside = sum(o.end_ns - o.start_ns for o in dev
                     if covered(o.start_ns))
        total = sum(o.end_ns - o.start_ns for o in dev) or 1
        return Reduced(dev, busy_s, window_s, [list(t) for t in top],
                       _label_gaps(merged, host), inside / total)


def _label_gaps(merged, host) -> list:
    """Idle time between device intervals, summed by the innermost host
    span (the chain of spans around it, outermost first) at each gap's
    middle; "host" where no span covers it."""
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, a1), (b0, _) in zip(merged[:-1], merged[1:]):
        if b0 <= a1:
            continue
        mid = (a1 + b0) // 2
        i = bisect.bisect_right(starts, mid)
        cover = sorted((h for h in host[:i] if h[1] >= mid),
                       key=lambda h: h[0])
        label = " > ".join(h[2][len(SPAN_PREFIX):] for h in cover) or "host"
        gaps[label] += (b0 - a1) / 1e9
    return [list(t) for t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]


class CallLog:
    """Keeps the arguments of calls to module-level functions of the
    program while `on`; the functions are patched in their module for the
    process's life, and the calls pass straight through while off."""

    def __init__(self):
        self.calls = defaultdict(list)
        self.on = False

    def watch(self, module: str, fn: str):
        key = f"{module}.{fn}"
        if key in self.calls:
            return
        mod = importlib.import_module(module)
        orig = getattr(mod, fn)
        log = self

        def wrapped(*args, **kwargs):
            if log.on:
                log.calls[key].append((args, kwargs))
            return orig(*args, **kwargs)

        # the program counts launches on its functions' attributes, through
        # the module's name: the wrapper carries them on
        wrapped.__dict__.update(orig.__dict__)
        setattr(mod, fn, wrapped)
        self.calls[key] = []
