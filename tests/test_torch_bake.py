"""The baked dense levels of a frozen hash table against the JAX package
(CPU): the bake (`build_baked_dense`), the baked encode through a baked
`HashField`, one stage-3 distill step with a baked cell-mode teacher, and
that the baked table stays out of checkpoints.

Tolerances:
  * the bake: exact.  The JAX package builds it with eager ops (no FMA
    contraction), and the port repeats each product and sum in float32;
  * the baked encode: 1e-6 absolute on O(1) tables against JAX's jitted
    encode (the same weights, as XLA:CPU contracts x01 * scale + 0.5 into
    an FMA as the port does; the 8-corner sums in another order, through
    the JAX package's 0/1 matmul; measured up to 1.8e-7);
  * at the fine lattice's interior vertices the baked encode equals the
    exact encode to rtol 1e-4 + atol 2e-3 on a 1e4-scaled table, the JAX
    package's own test (tests/test_hashgrid.py:181);
  * the distill step: tests/test_torch_distill.py's tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.models import hash_field as j_hash
from pvd_tpu.ops.hashgrid import HashGridSpec as JHashGridSpec
from pvd_tpu.ops.hashgrid import baked_dense_plan as j_plan
from pvd_tpu.ops.hashgrid import build_baked_dense as j_bake
from pvd_tpu.ops.hashgrid import hash_encode as j_hash_encode
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, build_baked_dense,
                                        build_baked_dense_plain, hash_encode)
from pvd_tpu_torch.params import hash_field_from_jax, hash_tree_from_field
from test_torch_distill import _check_whole_step

torch.set_num_threads(1)

ENC_ATOL = 1e-6
# a test width with 3 dense levels; the INGP teacher at bound 1 (side 73,
# Ld 5) and bound 2 (side 59, Ld 4), cell mode as the quality recipe has
# it; and K16's hard specs but the largest (chip_smoke.K16_HARD_SPECS: one
# dense level, three, base resolution 4; the 2^22 hash map's side 152 is
# held on the card only)
SPECS = {
    "test_width": dict(num_levels=5, base_resolution=4,
                       desired_resolution=32, log2_hashmap_size=12),
    "bound1": dict(desired_resolution=2048, n_cell_levels=9),
    "bound2": dict(desired_resolution=4096, n_cell_levels=9),
    **{k: v for k, v in chip_smoke.K16_HARD_SPECS.items() if k != "log2_22"},
}
# the dense levels' sides of every spec but the test width
DENSE_SIDES = {"bound1": [17, 25, 35, 51, 73], "bound2": [17, 26, 39, 59],
               "one_level": [17], "three_levels": [17, 25, 35],
               "base_res4": [5, 8, 12, 18, 29, 46, 73]}


def _table(spec, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_bake_matches_jax(name):
    """The vertex table: JAX's packed row v holds vertex v in corner 0."""
    js, ts = JHashGridSpec(**SPECS[name]), HashGridSpec(**SPECS[name])
    fine, dense = j_plan(js)
    assert ts.dense_levels == list(dense) and ts.dense_levels[-1] == fine
    if name != "test_width":
        assert [ts.level_side(lv) for lv in dense] == DENSE_SIDES[name]
    else:
        assert len(dense) >= 3
    table = _table(ts)
    packed, _, _ = j_bake(jnp.asarray(table), js)
    want = np.asarray(packed)[:, :2 * len(dense)]
    got = build_baked_dense(torch.from_numpy(table), ts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        build_baked_dense_plain(torch.from_numpy(table), ts).numpy(), want)


def _points(bound, n, rng):
    """Random points in the cube, plus its corners, points on its faces,
    next to its far faces and outside it."""
    x = rng.uniform(-bound, bound, (n, 3)).astype(np.float32)
    b, e = bound, np.float32(bound) * (1 - 1e-6)
    x[:12] = [[-b, -b, -b], [b, b, b], [-b, b, 0], [b, -b, b], [b, b, 0.3],
              [e, e, e], [b, e, -b], [0.1, b, e],
              [-b * 1.001, 0, 0], [0, b * 1.002, 0], [0.2, 0.1, -3 * b],
              [b, b, b * 1.0001]]
    return x


HARD = chip_smoke.HARD_COUNTS[:4]


@pytest.mark.parametrize(
    "cell,n", [(0, None), (9, None)] + [(9, n) for n in HARD],
    ids=["cell0", "cell9"] + [f"cell9-hard{n}" for n in HARD])
def test_baked_field_encode_matches_jax(cell, n):
    """A baked HashField (full width, bound 1) against the JAX field's
    _encode on attach_packed params, and the same field unbaked for the
    levels the bake leaves alone.  Seeded points (`_points`), or K15's hard
    points (`chip_smoke.hard_points`, the ones the card holds K15 to, at
    ragged counts: corners and far faces, 1 - 2^-24, just outside the cube,
    NaN alone and beside a coordinate outside) mapped to [-1, 1]^3; a NaN
    point's row is NaN, an outside point's 0."""
    kw = dict(hash_cell_levels=cell, hash_bake_dense=True)
    spec_j, spec_t = JModelSpec(**kw), ModelSpec(**kw)
    tree = jax.tree_util.tree_map(np.asarray, j_hash.init(
        jax.random.PRNGKey(1), spec_j))
    rng = np.random.default_rng(1)
    for k in ("encoder", "encoder_cell"):
        if k in tree:
            tree[k] = rng.uniform(-1, 1, tree[k].shape).astype(np.float32)
    params_j = j_hash.attach_packed(
        jax.tree_util.tree_map(jnp.asarray, tree), spec_j)
    x = _points(1.0, 3000, rng) if n is None else \
        chip_smoke.hard_points(n, 3) * np.float32(2) - np.float32(1)
    want = np.asarray(jax.jit(lambda p, xx: j_hash._encode(p, spec_j, xx))(
        params_j, jnp.asarray(x)))
    field = hash_field_from_jax(tree, spec_t, "cpu").bake()
    assert field.baked is not None and tuple(field.baked.shape) == (73 ** 3,
                                                                    10)
    with torch.no_grad():
        got = field.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL)
    if n is None:
        inside = np.r_[0:8, 12:len(x)]
        assert (got[8:12] == 0).all() and \
            (np.abs(got[inside]).sum(-1) > 0).all()
    else:
        nan = np.isnan(x).any(-1)
        outside = (np.abs(x) > 1).any(-1) & ~nan
        assert np.isnan(got).all(-1).tolist() == nan.tolist()
        assert (got[outside] == 0).all()
        assert (np.abs(got[~nan & ~outside]).sum(-1) > 0).all()
    # the levels the bake leaves alone are the exact encode's
    exact = jax.jit(lambda t, c, xx: j_hash_encode(
        t, xx, j_hash.grid_spec(spec_j), cell_table=c))(
            jnp.asarray(tree["encoder"]), tree.get("encoder_cell"),
            jnp.asarray((x + 1.0) / 2.0))
    rest = [lv for lv in range(14) if lv not in field.grid.dense_levels]
    cols = np.concatenate([[2 * lv, 2 * lv + 1] for lv in rest])
    np.testing.assert_allclose(got[:, cols], np.asarray(exact)[:, cols],
                               rtol=0, atol=ENC_ATOL)


def test_baked_dense_exact_at_fine_vertices():
    """At the fine lattice's interior vertices every dense level's baked
    value equals the exact encode (the bake samples there); the JAX
    package's tests/test_hashgrid.py:181 on the port."""
    spec = HashGridSpec(num_levels=5, base_resolution=4,
                        desired_resolution=32, log2_hashmap_size=12)
    fine, dense = spec.dense_levels[-1], spec.dense_levels
    rng = np.random.default_rng(3)
    table = torch.from_numpy(
        rng.uniform(-1e-4, 1e-4, (spec.table_size, 2)).astype(np.float32)
        * 1e4)
    baked = build_baked_dense(table, spec)
    scale_f = spec.level_scale(fine)
    v = np.arange(2, 12, dtype=np.float64)
    x1 = (v - 0.5) / scale_f
    g = torch.from_numpy(np.stack(np.meshgrid(x1[:4], x1[:4], x1[:4],
                                              indexing="ij"),
                                  axis=-1).reshape(-1, 3).astype(np.float32))
    with torch.no_grad():
        ref = hash_encode(table, g, spec).numpy()
        bak = hash_encode(table, g, spec, baked=baked).numpy()
    for lvl in dense:
        np.testing.assert_allclose(bak[:, 2 * lvl:2 * lvl + 2],
                                   ref[:, 2 * lvl:2 * lvl + 2],
                                   rtol=1e-4, atol=2e-3)
    rest = [lv for lv in range(5) if lv not in dense]
    for lvl in rest:
        np.testing.assert_array_equal(bak[:, 2 * lvl:2 * lvl + 2],
                                      ref[:, 2 * lvl:2 * lvl + 2])


@pytest.fixture(scope="module")
def cell_setup():
    from test_torch_distill import CELL_TEA_KW, _build

    return _build(CELL_TEA_KW)


def test_baked_cell_teacher_whole_step_matches_jax(cell_setup):
    """One stage-3 distill step whose cell-mode teacher (2 dense levels,
    2 cell levels) replays through its baked table, on both sides."""
    assert HashGridSpec(num_levels=6, base_resolution=4,
                        desired_resolution=64, log2_hashmap_size=9,
                        n_cell_levels=2).dense_levels == [0, 1]
    _check_whole_step(cell_setup, bake=True)


def test_baked_table_stays_out_of_checkpoints(tmp_path):
    """The distill Trainer bakes the loaded teacher; the baked table is a
    buffer no checkpoint, state_dict or pytree holds, and grad mode
    refuses it.  A teacher-mode Trainer ignores hash_bake_dense."""
    kw = dict(hash_num_levels=5, hash_base_res=4, hash_desired_res=32,
              hash_log2_size=12, compute_dtype="float32")
    spec = ModelSpec(**kw, hash_bake_dense=True)
    field = HashField(spec, "cpu").requires_grad_(False)
    ws = str(tmp_path)
    occ_cfg = dict(grid_size=16, hash_bake_dense=True)
    tea = Trainer(PVDConfig(**occ_cfg, workspace=ws), device="cpu")
    assert tea.state.field.baked is None
    path = ckpt.save_checkpoint(ws, "hash", 0, hash_tree_from_field(field),
                                tea.state.occ)
    distill = Trainer(PVDConfig(**occ_cfg, model_type="vm", resolution0=8,
                                workspace=ws), mode="distill", device="cpu")
    distill.spec_tea = spec
    distill.load_teacher(path)
    teacher = distill.teacher
    assert teacher.baked is not None
    assert "baked" not in teacher.state_dict()
    assert set(hash_tree_from_field(teacher)) == \
        set(hash_tree_from_field(field))
    again = ckpt.save_checkpoint(ws, "again", 0, hash_tree_from_field(teacher),
                                 tea.state.occ)
    payload = ckpt.load_checkpoint(again, "cpu")
    assert set(payload["params"]) == {"encoder", "sigma_net", "color_net"}
    with pytest.raises(RuntimeError, match="no_grad"):
        teacher.encode(torch.zeros(4, 3))
    assert os.path.exists(path)
