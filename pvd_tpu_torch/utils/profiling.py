"""Tracing: the program's own spans and counters, and a Chrome trace.

`span(name, unit=None)` and `count(name, n=1)` record while a
`torch.profiler` session is open, and only then.  A span is (name, start
ns, end ns, parent, unit) on `time.time_ns()`, the clock of the
profiler's own records; `parent` is the index of the enclosing span in
`records()` (None at the top), so a layer's self time is its span less
its children; `unit` is the step index or image ordinal that the spans of
one step or one image share, taken from the enclosing span when not
given.  A new session starts with an empty list; `records()` and
`counters()` return what the last session recorded.  With no session
open, `span` returns one shared object that does nothing: no clock read
and no allocation.

`sync(device)` and `readback(tensor)` block the host on the device, each
inside a `sync` span: the training loop's and the eval renderer's waits
go through them, so a trace shows where the host waited.

`trace(log_dir)` profiles the block into `<log_dir>/trace.json`, readable
in Perfetto or chrome://tracing: the device's kernels, copies and fills
on CUDA (the host's ops on a machine without CUDA), and the program's
spans beside them on the same time base; a no-op when `log_dir` is
falsy.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class _Recorder:
    """The session's spans, a column each (name, start ns, end ns, parent,
    unit), the indices of the open ones (innermost last) and the counters.
    The columns hold strings and ints alone, which Python's garbage
    collector does not track: a record kept as a list or tuple would be
    one more tracked object each, and a long session would run the
    collector over the whole heap ever more often."""

    def __init__(self):
        self.session = 0
        self.reset()

    def reset(self):
        self.session += 1
        self.names, self.starts, self.ends = [], [], []
        self.parents, self.units = [], []
        self.open = []
        self.counts = {}


_REC = _Recorder()


def _on_profiler_start(_start=_autograd_profiler._run_on_profiler_start):
    _start()
    _REC.reset()


# every profiler session (torch.profiler.profile and the autograd
# profiler alike) opens through this hook: a new session, a new list
_autograd_profiler._run_on_profiler_start = _on_profiler_start


class _Off:
    """The span of a run without a profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "unit", "index", "session")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        rec = _REC
        parent = rec.open[-1] if rec.open else None
        unit = self.unit
        if unit is None and parent is not None:
            unit = rec.units[parent]
        self.index, self.session = len(rec.names), rec.session
        rec.open.append(self.index)
        rec.names.append(self.name)
        rec.parents.append(parent)
        rec.units.append(unit)
        rec.ends.append(None)
        rec.starts.append(time.time_ns())
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        rec = _REC
        if rec.session == self.session:
            rec.ends[self.index] = t
            rec.open.pop()
        return False


def span(name: str, unit=None):
    """A context manager that records the block as a span while a profiler
    session is open; the shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` while a profiler session is open."""
    if _autograd_profiler._is_profiler_enabled:
        c = _REC.counts
        c[name] = c.get(name, 0) + n


def records() -> list:
    """The last session's spans, in start order: (name, start ns, end ns,
    parent index or None, unit); the end is None while a span is open."""
    rec = _REC
    return list(zip(rec.names, rec.starts, rec.ends, rec.parents,
                    rec.units))


def counters() -> dict:
    """The last session's counters."""
    return dict(_REC.counts)


def sync(device):
    """Wait for the device's queued work (a no-op off CUDA), in a `sync`
    span."""
    with span("sync"):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def readback(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host (itself when it is there already), in a `sync` span:
    a device tensor's copy waits for its queued work."""
    with span("sync"):
        return t.cpu()


def _add_spans(path: str):
    """Write the session's spans into the Chrome trace at `path` as
    complete events of the program's thread."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    for i, (name, t0, t1, parent, unit) in enumerate(records()):
        if t1 is None:
            continue
        data["traceEvents"].append({
            "ph": "X", "cat": "program", "name": name, "pid": pid,
            "tid": tid, "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
            "args": {"index": i, "parent": parent, "unit": unit}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block into `<log_dir>/trace.json`; a no-op when log_dir
    is falsy.  On CUDA the profiler records the device alone: recording
    the host's ops too made a distillation step 13x as long."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path)
