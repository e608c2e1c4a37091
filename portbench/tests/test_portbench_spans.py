"""The readers of the program's own spans and counters (`spans.py`, the
seven metrics that read them) on hand-made records: each gives its
hand-counted value, spans that start outside the window are left out, a
span inside another it counts is counted once, and a program without the
recorder gives nothing; the Trainer's once-an-epoch spans weigh once an
epoch.  On the card: a span around a kernel's launch
holds the start of that kernel's device record, on the profiler's
clock."""

import sys

import pytest

from portbench import harness, spans
from portbench.trace import SPANS

MS = 1_000_000  # ns

# the benchmark's first host span opens the window at 1 ms; 10 ms of wall
BENCH_SPANS = [(1 * MS, 4 * MS, "portbench.step"),
               (5 * MS, 8 * MS, "portbench.step")]
WALL_S = 0.010


def rec(name, t0, t1, parent=None, unit=None):
    return (name, int(t0 * MS), None if t1 is None else int(t1 * MS),
            parent, unit)


# two steps: (name, start ms, end ms, parent index, unit)
DISTILL = [
    rec("trainer.poses", 1.0005, 1.1005, None, 0),             # 0: 0.1
    rec("trainer.step", 1.1005, 4.1005, None, 0),              # 1: 3 ms
    rec("step.rays", 1.11, 1.2, 1, 0),                         # 2
    rec("step.loss", 1.2, 3.0, 1, 0),                          # 3
    rec("render.march", 1.2, 1.4, 3, 0),                       # 4: 0.2
    rec("render.field", 1.4, 1.9, 3, 0),                       # 5: 0.5
    rec("step.backward", 3.0, 3.5, 1, 0),                      # 6: 0.5
    rec("step.adamw", 3.5, 3.8, 1, 0),                         # 7: 0.3
    rec("trainer.tick", 4.1005, 4.3005, None, 1),              # 8
    rec("sync", 4.1005, 4.3005, 8, 1),                         # 9: 0.2
    rec("trainer.step", 5.0, 8.0, None, 1),                    # 10: 3 ms
    rec("render.composite", 5.1, 5.4, 10, 1),                  # 11: 0.3
    rec("render.background", 5.2, 5.3, 11, 1),                 # 12: in 11
    rec("step.ema", 7.0, 7.1, 10, 1),                          # 13: 0.1
    rec("trainer.epoch", 9.0, 11.5, None, 1),                  # 14: to 11
    rec("sync", 9.0, 10.0, 14, 1),                             # 15: 1.0
    rec("sync", 11.5, 11.6, None, None),                       # after it
    rec("render.march", 11.6, 12.0, None, None),               # after it
    rec("trainer.log", 10.6, None, None, 1),                   # still open
]
EPOCH_LEN = 312  # a distillation epoch's poses, one a step
DISTILL_WANT = {
    # the wall less the steps, the poses and the epoch's end (cut at the
    # window's end), per step; the poses and the end once an epoch
    "trainer_ms_per_step.distill": (10.0 - 6.0 - 0.1 - 2.0) / 2
    + (0.1 + 2.0) / EPOCH_LEN,
    "sync_ms_per_step.distill": (0.2 + 1.0) / 2,
    "render_host_ms_per_step.distill": (0.2 + 0.5 + 0.3) / 2,
    "optim_host_ms_per_step.distill": (0.5 + 0.3 + 0.1) / 2,
}

# two images: the first with 3 chunk renders, the second with 2
RENDER = [
    rec("eval.image", 1.0002, 4.0, None, 0),                   # 0
    rec("eval.chunk", 1.1, 1.6, 0, 0),                         # 1
    rec("render.march", 1.1, 1.2, 1, 0),                       # 2: 0.1
    rec("render.field", 1.2, 1.5, 1, 0),                       # 3: 0.3
    rec("sync", 1.6, 2.0, 0, 0),                               # 4: 0.4
    rec("eval.assemble", 3.5, 4.0, 0, 0),                      # 5
    rec("sync", 3.6, 3.9, 5, 0),                               # 6: 0.3
    rec("eval.image", 5.0, 9.0, None, 1),                      # 7
    rec("render.composite", 5.5, 6.0, 7, 1),                   # 8: 0.5
    rec("sync", 8.0, 8.5, 7, 1),                               # 9: 0.5
    rec("render.compact", 11.2, 11.9, None, None),             # after it
]
RENDER_COUNTERS = {"eval.chunk_renders.r1": 3, "eval.chunk_renders.r2": 1,
                   "eval.chunk_renders.r3": 1}
RENDER_WANT = {
    "render_host_ms_per_image.render": (0.1 + 0.3 + 0.5) / 2,
    "sync_ms_per_image.render": (0.4 + 0.3 + 0.5) / 2,
    "chunk_renders_per_image.render": 5 / 2,
}


@pytest.fixture
def recorded(monkeypatch):
    """Hand-made records in place of the program's and the benchmark's."""
    def put(program_spans, program_counters):
        monkeypatch.setattr(SPANS, "records", list(BENCH_SPANS))
        monkeypatch.setattr(spans, "program",
                            lambda: (program_spans, program_counters))
    return put


def ctx(units):
    return {"wall_s": WALL_S, "units": units}


@pytest.mark.parametrize("name", sorted(DISTILL_WANT))
def test_distill_readers(recorded, name):
    recorded(DISTILL, {})
    got = harness.metric_reader(name).read(ctx(2))
    assert got == pytest.approx(DISTILL_WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(RENDER_WANT))
def test_render_readers(recorded, name):
    recorded(RENDER, RENDER_COUNTERS)
    got = harness.metric_reader(name).read(ctx(2))
    assert got == pytest.approx(RENDER_WANT[name], rel=1e-12)


def test_window_starts_at_the_first_host_span(recorded):
    recorded(DISTILL, {})
    assert spans.window(ctx(2), DISTILL) == (1 * MS, 11 * MS)
    # a program span before the benchmark's first opens the window
    early = [rec("sync", 0.5, 0.6)] + DISTILL[1:]
    assert spans.window(ctx(2), early) == (MS // 2, MS // 2 + 10 * MS)


def test_spans_outside_the_window_are_left_out(recorded):
    recorded(DISTILL, {})
    ns = spans.span_ns(ctx(2), spans.named("sync"))
    assert ns == pytest.approx(1.2 * MS)
    ns = spans.span_ns(ctx(2), spans.prefixed("render."))
    assert ns == pytest.approx(1.0 * MS)
    # a span that outlasts the window counts up to its end
    ns = spans.span_ns(ctx(2), spans.named("trainer.epoch"))
    assert ns == pytest.approx(2.0 * MS)


def test_trainer_weighs_each_epoch_span_at_its_mean(recorded):
    """Two poses draws (a resumed call draws at its start and again as
    its first epoch opens) and one boundary: each at its mean, once an
    epoch of 4 steps."""
    recs = [rec("trainer.poses", 1.0, 1.1), rec("trainer.poses", 1.1, 1.4),
            rec("trainer.step", 1.5, 4.5, None, 0),
            rec("trainer.step", 4.5, 7.5, None, 1),
            rec("trainer.epoch", 8.0, 9.0, None, 1)]
    recorded(recs, {})
    got = spans.trainer_ms_per_step(ctx(2), epoch_len=4)
    want = (10.0 - 6.0 - 0.4 - 1.0) / 2 + ((0.1 + 0.3) / 2 + 1.0) / 4
    assert got == pytest.approx(want, rel=1e-12)


PER_LAYER = sorted(DISTILL_WANT) + sorted(RENDER_WANT)


@pytest.mark.parametrize("name", PER_LAYER)
def test_no_recorder_reads_nothing(monkeypatch, name):
    """A program without the recorder (an older commit), or a session
    that recorded nothing: every reader gives None."""
    monkeypatch.setattr(SPANS, "records", list(BENCH_SPANS))
    monkeypatch.setattr(spans, "program", lambda: None)
    assert harness.metric_reader(name).read(ctx(2)) is None


def test_program_without_records_gives_none(monkeypatch):
    from pvd_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    assert spans.program() is None


def test_entries_list_their_readers():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in PER_LAYER:
        m = entries[name]
        cell = ("pvd_ingp_to_vm300.distill_s3_8k" if name.endswith(
            ".distill") else "ingp_synthetic.render_800")
        assert m["workloads"] == [cell] and m["better"] == "lower"
        assert m["source"] == ("program_counter" if name.startswith(
            "chunk_renders") else "program_span")


@pytest.mark.card
def test_span_holds_its_kernel_launch_on_the_profiler_clock(card):
    """A CUDA-only profiler session turns recording on; each of five
    spans around one kernel's launch (on an idle card) starts at or before
    that kernel's device record, within a few ms."""
    import torch
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    from pvd_tpu_torch.utils.profiling import records, span

    x = torch.ones(1 << 20, device=card)
    x.mul_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert autograd_profiler._is_profiler_enabled
        for _ in range(5):
            torch.cuda.synchronize()
            with span("launch"):
                x.mul_(1.0)
            torch.cuda.synchronize()
    assert not autograd_profiler._is_profiler_enabled
    launches = [r for r in records() if r[0] == "launch"]
    dev = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")
                 and "elementwise" in e.name())
    assert len(launches) == len(dev) == 5
    offsets = [d - s[1] for s, d in zip(launches, dev)]
    print(f"device start - span start (ns): {offsets}; span lengths "
          f"(ns): {[s[2] - s[1] for s in launches]}", file=sys.stderr)
    assert all(0 <= o <= 5 * MS for o in offsets), offsets
