"""pvd_tpu_torch's checkpoints, distillation poses, SSIM, dilated bitfield
and stage schedule against the JAX package (CPU).

Checkpoints: a `.ckpt` written by the JAX package's `save_checkpoint` loads
into the port with identical arrays, and one written by the port loads in
the JAX package's `load_checkpoint` with identical arrays: a cell-mode hash
field (the spec of tests/test_cell_mode.py: 6 levels, base 4, desired 64,
a 2^9 table, 2 cell levels), so `encoder_cell` is covered, and an
occupancy state with its dilated bitfield.  Everything else is exact
(the same numpy code, or boolean ops) except SSIM: 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.data import poses as j_poses
from pvd_tpu.engine import checkpoint as j_ckpt
from pvd_tpu.engine.trainer import Trainer as JTrainer
from pvd_tpu.models import hash_field as j_hash
from pvd_tpu.models import vm_field as j_vm
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import dilate_bitfield as j_dilate
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu.utils.metrics import compute_ssim as j_ssim
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data import poses
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.params import (hash_field_from_jax, hash_tree_from_field,
                                  occupancy_from_jax)
from pvd_tpu_torch.render.occupancy import dilate_bitfield
from pvd_tpu_torch.utils.metrics import compute_ssim

torch.set_num_threads(1)

CELL_SPEC = dict(hash_num_levels=6, hash_base_res=4, hash_desired_res=64,
                 hash_log2_size=9, hash_cell_levels=2)
OCC_KEYS = ("density_grid", "bitfield", "mean_density", "iter_density",
            "aabb_train", "aabb_infer")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def cell_field():
    """A JAX cell-mode hash tree with O(1) tables and a JAX occupancy
    state on a random 32^3 grid (two cascades: bound 2)."""
    spec = JModelSpec(**CELL_SPEC, bound=2.0)
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_hash.init(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(1)
    tree["encoder"] = rng.uniform(-1, 1, tree["encoder"].shape) \
        .astype(np.float32)
    tree["encoder_cell"] = rng.uniform(-1, 1, tree["encoder_cell"].shape) \
        .astype(np.float32)
    rs = JPVDConfig(grid_size=32, bound=2.0).render_spec()
    occ = j_set_bitfield(j_init_occ(rs),
                         jnp.asarray(rng.uniform(size=2 * 32 ** 3) < 0.02))
    occ = occ.replace(
        density_grid=jnp.asarray(rng.normal(size=(2, 32, 32, 32))
                                 .astype(np.float32)),
        mean_density=jnp.float32(0.37), iter_density=jnp.int32(21))
    return spec, tree, occ


def test_jax_checkpoint_loads_into_the_port(cell_field, tmp_path):
    spec, tree, occ = cell_field
    path = j_ckpt.save_checkpoint(
        str(tmp_path), "hash", 123,
        {**tree, "_packed": np.zeros(3, np.float32)}, occ,
        stats={"psnr": 30.5}, config_json=JPVDConfig(
            hash_cell_levels=2, iters=77).to_json())
    got = ckpt.load_checkpoint(path, "cpu")
    assert got["step"] == 123 and got["stats"] == {"psnr": 30.5}
    assert "_packed" not in got["params"] and "encoder_cell" in got["params"]
    _assert_trees_equal(got["params"], tree)
    for k in OCC_KEYS:
        a, b = getattr(got["occ"], k), getattr(occ, k)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=k)
    assert got["occ"].bitfield.dtype == torch.bool
    cfg = PVDConfig.from_json(got["config_json"])
    assert (cfg.hash_cell_levels, cfg.iters) == (2, 77)
    # the loaded tree builds the port's cell-mode field
    field = hash_field_from_jax(got["params"], ModelSpec(**CELL_SPEC,
                                                         bound=2.0), "cpu")
    assert field.encoder_cell.shape == tree["encoder_cell"].shape


def test_port_checkpoint_loads_in_jax(cell_field, tmp_path):
    spec, tree, occ_j = cell_field
    field = hash_field_from_jax(tree, ModelSpec(**CELL_SPEC, bound=2.0),
                                "cpu")
    occ = occupancy_from_jax(occ_j, "cpu")
    paths = [ckpt.save_checkpoint(str(tmp_path), "hash", s,
                                  hash_tree_from_field(field), occ,
                                  config_json=PVDConfig(iters=5).to_json())
             for s in (1, 2, 3)]
    # step retention keeps the last two; the latest is found
    assert not (tmp_path / "hash_step00000001.ckpt").exists()
    assert ckpt.latest_checkpoint(str(tmp_path), "hash") == paths[-1]
    best = ckpt.save_checkpoint(str(tmp_path), "hash", 3,
                                hash_tree_from_field(field), occ,
                                filename="hash_best.ckpt")
    got = j_ckpt.load_checkpoint(best)
    assert got["step"] == 3
    _assert_trees_equal(got["params"], tree)
    for k in OCC_KEYS + ("bitfield_dilated",):
        np.testing.assert_array_equal(np.asarray(getattr(got["occ"], k)),
                                      np.asarray(getattr(occ_j, k)),
                                      err_msg=k)
    assert JPVDConfig.from_json(j_ckpt.load_checkpoint(paths[-1])
                                ["config_json"]).iters == 5


@pytest.mark.parametrize("C,H,frac", [(1, 16, 0.01), (2, 8, 0.05),
                                      (1, 32, 0.002)])
def test_dilate_bitfield_matches_jax(C, H, frac):
    bits = np.random.default_rng(H).uniform(size=C * H ** 3) < frac
    want = np.asarray(j_dilate(jnp.asarray(bits), H))
    got = dilate_bitfield(torch.from_numpy(bits), H).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_warm_start_student_matches_jax():
    """hash -> vm: the color_net head transfers, the rest stays."""
    tea = jax.tree_util.tree_map(np.asarray, j_hash.init(
        jax.random.PRNGKey(1), JModelSpec(**CELL_SPEC)))
    stu = jax.tree_util.tree_map(np.asarray, j_vm.init(
        jax.random.PRNGKey(2), JModelSpec(model_type="vm",
                                          vm_resolution=(8, 10, 12))))
    want = jax.tree_util.tree_map(np.asarray,
                                  j_ckpt.warm_start_student(stu, tea))
    got = ckpt.warm_start_student(stu, tea)
    _assert_trees_equal(got, want)
    for a, b in zip(got["color_net"], tea["color_net"]):
        np.testing.assert_array_equal(a["w"], b["w"])
    np.testing.assert_array_equal(got["basis_mat"]["w"],
                                  stu["basis_mat"]["w"])


@pytest.mark.parametrize("data_type", ["synthetic", "tank", "llff"])
def test_get_rand_poses_matches_jax(data_type):
    train = np.stack([np.eye(4, dtype=np.float32)] * 3)
    train[:, :3, 3] = [[0.5, -1.0, 2.0], [1.5, 0.2, -0.3], [-0.7, 0.9, 1.1]]
    want = j_poses.get_rand_poses(np.random.default_rng(4), data_type, train)
    got = poses.get_rand_poses(np.random.default_rng(4), data_type, train)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert len(got) == {"synthetic": 312, "tank": 87, "llff": 30}[data_type]


def test_rand_orbit_poses_matches_jax():
    for size, radius in ((7, 3.2), (1, 1.0)):
        want = j_poses.rand_orbit_poses(np.random.default_rng(size), size,
                                        radius=radius)
        got = poses.rand_orbit_poses(np.random.default_rng(size), size,
                                     radius=radius)
        np.testing.assert_array_equal(got, want)


def test_compute_ssim_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1) \
        .astype(np.float32)
    for x, y in ((a, b), (a, a), (b, rng.uniform(size=a.shape))):
        assert abs(compute_ssim(x, y) - j_ssim(x, y)) <= 1e-6
    assert compute_ssim(a, a) == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["distill", "teacher"])
def test_stage_schedule_matches_jax(mode):
    """_stage_of over a run, for the same config (the JAX method reads
    only `mode` and `cfg`)."""
    kw = dict(stage1_iters=300, stage2_iters=800)
    fake = types.SimpleNamespace(mode=mode, cfg=JPVDConfig(**kw))
    want = [JTrainer._stage_of(fake, s) for s in range(0, 2000, 7)]
    port = types.SimpleNamespace(mode=mode, cfg=PVDConfig(**kw))
    got = [Trainer._stage_of(port, s) for s in range(0, 2000, 7)]
    assert got == want
    assert set(got) == ({1, 2, 3} if mode == "distill" else {3})
