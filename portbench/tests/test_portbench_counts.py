"""The yardstick's arithmetic against hand counts at small shapes: the
roofline bound, the model FLOPs, the touched rows, the readers, and the
reduction of a trace into busy time and labelled gaps."""

import pytest
import torch

from portbench import flops, harness, peaks, readers
from portbench.reference import nerf
from portbench.trace import DeviceOp, Reduced, _label_gaps

MODEL = {"model_type": "hash", "bound": 1.0, "hash_num_levels": 14,
         "hash_level_dim": 2, "hash_base_res": 16, "hash_log2_size": 19,
         "hash_desired_res": 2048, "num_layers": 2, "hidden_dim": 64,
         "geo_feat_dim": 15, "num_layers_color": 3, "hidden_dim_color": 64,
         "sh_degree": 4}
VM = {"model_type": "vm", "vm_sigma_rank": 16, "vm_color_rank": 48,
      "geo_feat_dim": 15, "num_layers_color": 3, "hidden_dim_color": 64,
      "sh_degree": 4}


def test_bound_picks_the_larger():
    t, by = peaks.bound(3.35e9, 0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = peaks.bound(0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)
    assert peaks.k8_bound(2, 4, 3)[0] == pytest.approx(
        (8 + 72 + 32 + 40) / 3.35e12 * 1e3)
    assert peaks.k9_bound(2, 4, 3)[0] == pytest.approx(
        (8 + 96 + 40 + 128) / 3.35e12 * 1e3)


def test_hash_flops_by_hand():
    interp = 14 * 8 * 2 * 2
    sigma = 2 * (28 * 64 + 64 * 16)
    color = 2 * (31 * 64 + 64 * 64 + 64 * 3)
    assert flops.forward(MODEL) == interp + sigma + color
    assert flops.forward(MODEL, color=False) == interp + sigma
    assert flops.sample_flops(MODEL, True) == 3 * (interp + sigma + color)


def test_vm_flops_by_hand():
    interp = 3 * 64 * (8 + 4 + 1)
    proj = 3 * 2 * 64 * 16
    color = 2 * (31 * 64 + 64 * 64 + 64 * 3)
    assert flops.forward(VM) == interp + proj + color
    assert flops.sample_flops(VM, False) == interp + proj + color


def test_hash_touched_rows_brute_force():
    grid = nerf.Grid(num_levels=3, base_resolution=4, log2_size=6,
                     desired_resolution=16)
    x = torch.rand(50, 3, generator=torch.Generator().manual_seed(0))
    want = 0
    for lv in range(3):
        _, rows = nerf.hash_corners(x, grid, lv)
        want += len({int(r) for r in rows.reshape(-1)})
    assert readers.hash_touched_rows(x, grid) == want


def test_vm_touched_rows_brute_force():
    planes = [torch.zeros(5, 4, 2), torch.zeros(6, 4, 2),
              torch.zeros(6, 5, 2)]
    lines = [torch.zeros(6, 2), torch.zeros(5, 2), torch.zeros(4, 2)]
    xn = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                       [-1.0, -1.0, -1.0]])
    # per branch: two distinct points, each with 4 plane taps and 2 line
    # taps, the corners of opposite cells: no tap shared
    assert readers.vm_touched_rows(planes, lines, xn) == 3 * (8 + 4)


def _ctx(ops, units=2, wall=1.0, **kw):
    red = Reduced(ops=ops, busy_s=0.25, window_s=wall, top_ops=[],
                  idle_gaps=[], in_spans=1.0)
    return dict(reduced=red, units=units, wall_s=wall, **kw)


def test_readers_by_hand():
    ops = [DeviceOp("void hash_encode_fwd_kernel<4>(...)", "kernel", 0,
                    2_000_000),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", "memcpy", 0, 1000),
           DeviceOp("nvjet_tst_128x64", "kernel", 0, 3_000_000),
           DeviceOp("void multi_tensor_apply_kernel<...>", "kernel", 0,
                    500_000)]
    ctx = _ctx(ops, flops=989e12 * 0.01)
    assert readers.launches(ctx) == 2.0
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.mfu(ctx) == pytest.approx(1.0)
    gemm = harness.metric_reader("gemm_ms_per_step.distill")
    assert gemm.read(ctx) == pytest.approx(1.5)
    optim = harness.metric_reader("optim_ms_per_step.distill")
    assert optim.read(ctx) == pytest.approx(0.25)
    assert readers.roofline(ctx, r"hash_encode_fwd_kernel", [0.5]) == \
        pytest.approx(25.0)
    assert readers.roofline(ctx, r"no_such_kernel", [0.5]) is None


def test_k1_reader_by_hand():
    cfg = {"model": dict(MODEL)}
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(1))
    grid = nerf.grid_of(MODEL)
    touched = readers.hash_touched_rows(x, grid)
    want = peaks.bound(64 * 12 + touched * 8 + 64 * 14 * 8,
                       64 * 14 * 50)[0]
    ops = [DeviceOp("void hash_encode_fwd_kernel<2>(...)", "kernel", 0,
                    1_000_000)]
    ctx = _ctx(ops, config=cfg, calls={
        "pvd_tpu_torch.ops.hashgrid.hash_encode_fwd": [((None, x), {})]})
    r = harness.metric_reader("k1_roofline.render").read(ctx)
    assert r == pytest.approx(100.0 * want / 1.0)


def test_k5_reader_by_hand():
    planes = [torch.zeros(5, 4, 8), torch.zeros(6, 4, 8),
              torch.zeros(6, 5, 8)]
    lines = [torch.zeros(6, 8), torch.zeros(5, 8), torch.zeros(4, 8)]
    xn = torch.rand(10, 3, generator=torch.Generator().manual_seed(3)) \
        * 2 - 1
    g = torch.zeros(3, 10, 8)
    g[:, :6] = 1.0
    touched = readers.vm_touched_rows(planes, lines, xn[:6])
    want = peaks.bound(10 * 12 + 3 * 10 * 8 * 4 + touched * 8 * 8,
                       3 * 6 * 8 * 26)[0]
    ops = [DeviceOp("void vm_sample_bwd_kernel<8, true>(...)", "kernel", 0,
                    4_000_000)]
    ctx = _ctx(ops, calls={"pvd_tpu_torch.ops.vm_sample.vm_sample_bwd": [
        ((planes, lines, xn, g), {})]})
    r = harness.metric_reader("k5_roofline.distill").read(ctx)
    assert r == pytest.approx(100.0 * want / 4.0)


def test_gap_labels():
    merged = [[0, 10], [20, 30], [40, 50], [60, 70], [200, 210]]
    host = [(0, 100, "portbench.step"), (12, 18, "portbench.render_rays"),
            (35, 45, "portbench.backward_adamw")]
    gaps = dict((k, v) for k, v in _label_gaps(merged, host))
    assert gaps["step > render_rays"] == pytest.approx(10e-9)
    assert gaps["step > backward_adamw"] == pytest.approx(10e-9)
    assert gaps["step"] == pytest.approx(10e-9)
    assert gaps["host"] == pytest.approx(130e-9)


def test_every_reader_returns_none_on_an_empty_trace():
    bench = harness.load_benchmark()
    ctx = _ctx([], units=0, wall=0.0, flops=0.0, calls={},
               config={"model": dict(MODEL)})
    for m in bench["per_layer"]:
        assert harness.metric_reader(m["name"]).read(ctx) is None, m["name"]

