"""pvd_tpu_torch's tracing (`utils/profiling.py`) on the CPU: the program's
spans and counters record inside a `torch.profiler` session and nowhere
else, nest with their parents and units, start afresh with each session,
and reach `trace`'s Chrome trace; the Trainer's loop and the eval
renderer record what they do (one `trainer.step` a step, the syncs the
loop makes, the chunk renders of each rung of the budget ladder); and
recording changes no output, bit for bit."""

import contextlib
import dataclasses
import gc
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.poses import rand_orbit_poses
from pvd_tpu_torch.engine.train_steps import chunk_rays, make_eval_renderer
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.ops.aabb import near_far_from_aabb
from pvd_tpu_torch.params import new_field
from pvd_tpu_torch.render.occupancy import init_occupancy_state, set_bitfield
from pvd_tpu_torch.render.renderer import march_rays
from pvd_tpu_torch.utils import profiling
from pvd_tpu_torch.utils.profiling import (count, counters, readback,
                                           records, span, sync, trace)

torch.set_num_threads(1)

# a stage-3 VM -> VM distillation small enough for a second on the CPU:
# compacted samples, a tick every 4 steps, 6 steps in the first epoch
DISTILL = dict(model_type="vm", teacher_type="vm", resolution0=8,
               resolution1=8, num_rays=32, grid_size=8, max_steps=32,
               max_samples=8, samples_per_ray=4.0, precision="fp32",
               iters=6, stage1_iters=0, stage2_iters=0,
               update_extra_interval=4, autotune_budget=False,
               eval_interval=10 ** 6)
VIEW = types.SimpleNamespace(poses=np.zeros((0, 4, 4), np.float32),
                             images=None, H=16, W=16,
                             intrinsics=(20.0, 20.0, 8.0, 8.0))
EVAL_CHUNK = 32


def session():
    return profile(activities=[ProfilerActivity.CPU])


def _names(recs):
    return [r[0] for r in recs]


def test_off_records_nothing(monkeypatch):
    """Without a session: the shared no-op, no clock read, nothing kept."""
    with session():
        pass
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time_ns=lambda: pytest.fail("the off path read the clock")))
    assert span("a") is span("b", unit=3)
    t = torch.arange(4.0)
    with span("a"):
        with span("b"):
            count("c")
            sync(torch.device("cpu"))
            assert readback(t) is t
    assert records() == [] and counters() == {}


def test_spans_nest_with_parents_and_units():
    with session():
        with span("a", unit=7):
            with span("b"):
                count("c", 2)
                count("c")
            with span("d", unit=8):
                pass
        with span("e"):
            count("f")
    recs = records()
    assert _names(recs) == ["a", "b", "d", "e"]
    assert [r[3] for r in recs] == [None, 0, 0, None]
    assert [r[4] for r in recs] == [7, 7, 8, None]
    for name, t0, t1, parent, _ in recs:
        assert t0 <= t1
        if parent is not None:
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]
    assert [r[1] for r in recs] == sorted(r[1] for r in recs)
    assert counters() == {"c": 3, "f": 1}


def test_records_leave_the_garbage_collector_alone():
    """A recorded span keeps no object that Python's garbage collector
    tracks, so a long session does not run the collector over the heap
    more often (records kept as lists did: one more tracked object a
    span)."""
    with session():
        gc.collect()
        gc.disable()  # the count then only grows
        try:
            before = gc.get_count()[0]
            for i in range(1000):
                with span("a", unit=i):
                    with span("b"):
                        pass
            grown = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert len(records()) == 2000
    assert grown < 100, grown


def test_each_session_starts_a_fresh_list():
    with session():
        with span("first"):
            count("n", 5)
    assert _names(records()) == ["first"] and counters() == {"n": 5}
    with session():
        with span("second"):
            count("m")
    assert _names(records()) == ["second"] and counters() == {"m": 1}


def test_sync_and_readback_are_counted_sync_spans():
    t = torch.arange(6.0).reshape(2, 3)
    with session():
        with span("outer", unit=1):
            sync(torch.device("cpu"))
            back = readback(t)
    assert back is t  # a host tensor comes back as itself
    recs = records()
    assert _names(recs) == ["outer", "sync", "sync"]
    assert [r[3] for r in recs] == [None, 0, 0]
    assert [r[4] for r in recs] == [1, 1, 1]
    assert counters() == {}


# `trace` records the device alone where CUDA is, the host's ops elsewhere:
# the matmul below runs where it is recorded, and its record is a kernel
# on the card and `aten::mm` on the host
CUDA = torch.cuda.is_available()


def _matmul():
    a = torch.rand(64, 64, device="cuda" if CUDA else "cpu")
    (a @ a).sum()
    if CUDA:
        torch.cuda.synchronize()


def _is_matmul(event) -> bool:
    if CUDA:
        return event.get("cat") == "kernel"
    return event.get("name") == "aten::mm"


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    _matmul()  # the first call's set-up outside the session
    with trace(log_dir):
        _matmul()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(_is_matmul(e) for e in events)


def test_trace_holds_the_program_spans_on_its_time_base(tmp_path):
    """A span around a matmul holds the profiler's record of it."""
    log_dir = str(tmp_path / "trace")
    _matmul()
    with trace(log_dir):
        with span("outer", unit=4):
            with span("inner"):
                _matmul()
    with open(os.path.join(log_dir, "trace.json")) as f:
        data = json.load(f)
    prog = {e["name"]: e for e in data["traceEvents"]
            if e.get("cat") == "program"}
    assert set(prog) == {"outer", "inner"}
    assert prog["inner"]["args"] == {"index": 1, "parent": 0, "unit": 4}
    mm = [e for e in data["traceEvents"] if _is_matmul(e)]
    inner = prog["inner"]
    eps = 0.01  # us: the ns records' rounding in the trace's floats
    assert mm and all(inner["ts"] - eps <= e["ts"] and e["ts"] + e["dur"]
                      <= inner["ts"] + inner["dur"] + eps for e in mm)


def test_trace_without_a_directory_does_nothing(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for off in (None, ""):
            with trace(off):
                torch.ones(3).sum()
        assert os.listdir(tmp_path) == []
    finally:
        os.chdir(cwd)


def _distill_trainer(ws: str) -> Trainer:
    tr = Trainer(PVDConfig(**DISTILL, workspace=ws), mode="distill",
                 device="cpu")
    full = torch.ones_like(tr.state.occ.bitfield)
    tr.state.occ = set_bitfield(tr.state.occ, full)
    tr.occ_tea = set_bitfield(tr.occ_tea, full)
    return tr


def _ancestors(recs, i):
    while recs[i][3] is not None:
        i = recs[i][3]
        yield recs[i]


def test_trainer_records_its_loop(tmp_path):
    """One `trainer.step` and one `trainer.draw` a step, its unit the step;
    the epoch's poses drawn once; every `step.*` and `render.*` span
    inside a `trainer.step` (the student's render and the teacher's
    replay: two of each render stage a step); the loop's `sync` spans by
    hand: the first, two a tick (steps 0 and 4), one readback per logged
    value at step 0, two at the epoch's end, the last."""
    tr = _distill_trainer(str(tmp_path))
    with session():
        tr.train(VIEW)
    recs = records()
    steps = [r for r in recs if r[0] == "trainer.step"]
    assert [r[4] for r in steps] == list(range(6))
    for i, r in enumerate(recs):
        if r[0].startswith(("step.", "render.")):
            owner = [a for a in _ancestors(recs, i)
                     if a[0] == "trainer.step"]
            assert len(owner) == 1 and owner[0][4] == r[4], r
    names = _names(recs)
    for stage in ("march", "compact", "field", "composite"):
        assert names.count(f"render.{stage}") == 2 * 6
    for part in ("loss", "backward", "adamw"):
        assert names.count(f"step.{part}") == 6
    assert "step.ema" not in names  # EMA is off
    assert names.count("trainer.draw") == 6
    assert names.count("trainer.poses") == names.count("trainer.epoch") == 1
    want = 1 + 2 * 2 + len(tr.history[0]) + 2 + 1
    assert names.count("sync") == want


def _ball_grid(rs):
    H = rs.grid_size
    g = torch.stack(torch.meshgrid(*[torch.arange(H)] * 3, indexing="ij"),
                    -1).float()
    ball = ((g - (H - 1) / 2).norm(dim=-1) < H * 0.45).reshape(-1)
    return set_bitfield(init_occupancy_state(rs, "cpu"), ball)


def _eval_setup(spr: float):
    cfg = PVDConfig(**dict(DISTILL, samples_per_ray=spr))
    spec, rs = cfg.model_spec(), cfg.render_spec()
    field = new_field(spec, "cpu", torch.Generator().manual_seed(0))
    pose = rand_orbit_poses(np.random.default_rng(0), 1, radius=2.5)[0]
    render = make_eval_renderer(spec, rs, chunk=EVAL_CHUNK, device="cpu")
    return field, _ball_grid(rs), rs, pose, render


@pytest.mark.parametrize("spr", [0.5, 2.0, 4.0])
def test_eval_image_counts_chunk_renders_per_rung(spr):
    """The rung counters against each chunk's valid samples (the eval
    march's) and the ladder's budgets: every chunk on rung 1, those over
    a rung's budget on the next, those over the last rung's truncated."""
    field, occ, rs, pose, render = _eval_setup(spr)
    with session():
        out = render(field, occ, pose, VIEW.intrinsics, VIEW.H, VIEW.W)
    ev = dataclasses.replace(rs, max_samples=rs.max_steps)
    pose_t = torch.as_tensor(pose)
    totals = []
    for head in range(0, VIEW.H * VIEW.W, EVAL_CHUNK):
        o, d = chunk_rays(pose_t, VIEW.intrinsics, VIEW.H, VIEW.W, head,
                          EVAL_CHUNK)
        o, d = o.contiguous(), d.contiguous()
        nears, fars = near_far_from_aabb(o, d, occ.aabb_infer, rs.min_near)
        totals.append(int(march_rays(occ.bitfield, o, d, nears, fars,
                                     ev).mask.sum()))
    budgets = [dataclasses.replace(ev, samples_per_ray=spr * k)
               .sample_budget(EVAL_CHUNK) for k in (1, 4, 16)]
    want = {"eval.chunk_renders.r1": len(totals)}
    for k in (1, 2):
        over = sum(t > budgets[k - 1] for t in totals)
        if over:
            want[f"eval.chunk_renders.r{k + 1}"] = over
    assert out.rungs == len(want)
    n_trunc = sum(t > budgets[2] for t in totals) if out.rungs == 3 else 0
    assert out.truncated_chunks == n_trunc
    assert counters() == want
    assert out.samples == sum(totals)
    recs = records()
    # a readback a rung, and the samples'
    assert _names(recs).count("sync") == out.rungs + 1
    assert _names(recs).count("eval.image") == 1
    assert _names(recs).count("eval.chunk") == sum(want.values())


def test_recording_changes_no_output(tmp_path):
    """The same distillation and the same image with recording on and
    off, bit for bit."""
    runs, kept = [], []
    field, occ, _, pose, render = _eval_setup(2.0)
    for on in (True, False):
        tr = _distill_trainer(str(tmp_path / str(on)))
        with session() if on else contextlib.nullcontext():
            tr.train(VIEW)
            img = render(field, occ, pose, VIEW.intrinsics, VIEW.H, VIEW.W)
        runs.append(([h["loss"] for h in tr.history],
                     list(tr.state.field.parameters()), img))
        kept.append(len(records()))
    assert kept[0] > 0 and kept[1] == kept[0]  # the run off added nothing
    (loss_a, par_a, img_a), (loss_b, par_b, img_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(loss_a, loss_b))
    assert all(torch.equal(a, b) for a, b in zip(par_a, par_b))
    for a, b in zip(img_a[:3], img_b[:3]):
        assert torch.equal(a, b)
    assert img_a[3:] == img_b[3:]
