"""The plain reference against the program's plain path at tiny sizes on
the CPU, and the whole check of each cell at a tiny size: the program's
run passes, and the control and planted faults fail."""

import numpy as np
import pytest
import torch

from portbench import faults
from portbench.reference import nerf
from portbench.tests.tiny import correct, run_cell

CELLS = ("pvd_ingp_to_vm300.distill_s3_8k", "ingp_synthetic.render_800")
GEN = torch.Generator().manual_seed(0)


def test_hash_encode_matches_the_plain_version():
    from pvd_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode_plain
    spec = HashGridSpec(num_levels=5, base_resolution=4,
                        log2_hashmap_size=10, desired_resolution=64)
    grid = nerf.Grid(5, 2, 4, 10, 64)
    assert grid.table_rows == spec.table_size
    table = torch.rand(spec.table_size, 2, generator=GEN)
    x = torch.rand(300, 3, generator=GEN) * 1.2 - 0.1
    assert torch.equal(nerf.hash_encode(table, x, grid),
                       hash_encode_plain(table, x, spec))


def test_vm_sample_matches_the_plain_version():
    from pvd_tpu_torch.ops.vm_sample import vm_sample_plain
    res = (7, 9, 5)
    planes = [torch.randn(res[m1], res[m0], 6, generator=GEN)
              for m0, m1 in nerf.MAT_IDS]
    lines = [torch.randn(res[v], 6, generator=GEN) for v in nerf.VEC_IDS]
    xn = torch.rand(200, 3, generator=GEN) * 2.2 - 1.1
    assert torch.equal(nerf.vm_sample(planes, lines, xn),
                       vm_sample_plain(planes, lines, xn))


@pytest.mark.parametrize("S", [8, 64])
def test_march_and_compaction_match_the_plain_version(S):
    from pvd_tpu_torch.config import RenderSpec
    from pvd_tpu_torch.ops.aabb import near_far_from_aabb
    from pvd_tpu_torch.render.renderer import compact_samples, \
        march_rays_plain
    rs = RenderSpec(grid_size=8, max_steps=64, max_samples=S)
    render = {"grid_size": 8, "max_steps": 64, "bound": 1.0,
              "min_near": 0.2}
    bits = torch.rand(8 ** 3, generator=GEN) < 0.3
    o = torch.randn(40, 3, generator=GEN)
    o = 2.5 * o / o.norm(dim=-1, keepdim=True)
    d = -o / o.norm(dim=-1, keepdim=True) + 0.2 * torch.randn(
        40, 3, generator=GEN)
    d = d / d.norm(dim=-1, keepdim=True)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1])
    u = torch.rand(40, generator=GEN)
    n, f = nerf.near_far(o, d, aabb, 0.2)
    n2, f2 = near_far_from_aabb(o, d, aabb, 0.2)
    assert torch.equal(n, n2) and torch.equal(f, f2)
    t, dt, mask, t0 = nerf.march(bits, o, d, n, f, render, S, u)
    p = march_rays_plain(bits, o, d, n, f, rs, u)
    assert torch.equal(t, p.t) and torch.equal(mask, p.mask)
    assert torch.equal(dt, p.dt) and torch.equal(t0, p.t0)
    prefix = S < 64
    a = nerf.compact(mask, 128, prefix)
    b = compact_samples(mask, 128, prefix)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("early_stop", [False, True])
def test_composite_matches_the_plain_version(early_stop):
    from pvd_tpu_torch.ops.composite import composite_rays_compact_plain
    M, N = 60, 7
    rid = torch.sort(torch.randint(0, N, (M,), generator=GEN)).values
    valid = torch.arange(M) < 50
    sig = torch.rand(M, generator=GEN) * 30
    rgb = torch.rand(M, 3, generator=GEN)
    dt = torch.full((M,), 0.01)
    tc = torch.rand(M, generator=GEN)
    a = nerf.composite(sig, rgb, dt, tc, rid, valid, N, early_stop)
    b = composite_rays_compact_plain(sig, rgb, dt, tc, rid, valid, N,
                                     early_stop)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sh_and_rays_match_the_plain_versions():
    from pvd_tpu_torch.ops.rays import pixel_dirs, rotate
    from pvd_tpu_torch.ops.sh import sh_encode
    d = torch.randn(100, 3, generator=GEN)
    d = d / d.norm(dim=-1, keepdim=True)
    assert torch.equal(nerf.sh4(d), sh_encode(d, 4))
    intr = (40.0, 40.0, 16.0, 16.0)
    inds = torch.randint(0, 32 * 32, (50,), generator=GEN)
    pose = torch.randn(4, 4, generator=GEN)
    o, dd = nerf.rays(pose, intr, inds, 32, 32)
    want = rotate(pixel_dirs(intr, inds, 32, 32), pose[:3, :3])
    assert torch.equal(dd, want)
    assert torch.equal(o, pose[:3, 3].expand_as(want))


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    return request.param, run_cell(request.param)


def test_program_passes_at_a_tiny_size(sound):
    name, (runner, res, limits) = sound
    checks = runner.check()
    assert res["units"] > 0 and res["failed"] == 0
    assert correct(checks, limits), checks


def test_control_fails(sound):
    name, (runner, _, limits) = sound
    assert not correct(runner.check(control=True), limits)


def test_distill_poses_are_the_trainers():
    from pvd_tpu_torch.data.poses import get_rand_poses
    from portbench.reference.poses import distill_epoch_poses
    want = get_rand_poses(np.random.default_rng(2 ** 33 + 5), "synthetic")
    assert np.array_equal(distill_epoch_poses(2 ** 33 + 5), want)


FAULTS = [
    ("pvd_ingp_to_vm300.distill_s3_8k", "unchanged"),
    ("pvd_ingp_to_vm300.distill_s3_8k", "half_batch"),
    ("ingp_synthetic.render_800", "answer"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_fails(cell, fault):
    undo = faults.plant(fault, "distill" if "distill" in cell else "render")
    try:
        runner, _, limits = run_cell(cell)
        assert not correct(runner.check(), limits)
    finally:
        for u in undo:
            u()


def test_one_leaf_moves_the_worst_gap_and_not_the_median():
    from portbench.drivers.train import gaps
    names = [f"leaf{i}" for i in range(5)]
    ref = ([1.0, 1.0, 1.0], {n: 1.0 for n in names}, {n: 2.0 for n in names})
    side = ([1.0, 1.0, 1.0], dict(ref[1], leaf0=1.1), dict(ref[2], leaf0=2.2))
    out = gaps(side, ref)
    assert out["grad_gap"] == pytest.approx(0.1)
    assert out["change_gap"] == pytest.approx(0.1)
    assert out["grad_gap_median"] == 0.0 and out["change_gap_median"] == 0.0
