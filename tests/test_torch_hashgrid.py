"""pvd_tpu_torch hash grid against the JAX package (CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pvd_tpu.models import hash_field as j_hash_field
from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.ops.hashgrid import HashGridSpec as JHashGridSpec
from pvd_tpu.ops.hashgrid import _level_corner_plan
from pvd_tpu.ops.hashgrid import hash_encode as j_hash_encode
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.hash_field import grid_spec
from pvd_tpu_torch.ops import hashgrid
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, hash_encode,
                                        hash_encode_bwd_plain,
                                        hash_encode_cell_bwd_plain,
                                        hash_encode_cell_fwd,
                                        hash_encode_cell_plain,
                                        hash_encode_plain)

torch.set_num_threads(1)

# table values are O(1) here; the corner sums run in another order than
# XLA's (which also sums the dense levels through a 0/1 matmul)
ENC_TOL = 1e-5

SMALL = dict(num_levels=4, log2_hashmap_size=14, desired_resolution=128)


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "ingp_default"])
def test_spec_matches_jax(kw):
    js, ts = JHashGridSpec(**kw), HashGridSpec(**kw)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    assert ts.table_size == js.table_size
    assert ts.per_level_scale == js.per_level_scale
    assert ts.output_dim == js.output_dim
    for lvl in range(ts.num_levels):
        assert ts.level_scale(lvl) == js.level_scale(lvl)
        assert ts.level_resolution(lvl) == js.level_resolution(lvl)
        assert ts.level_is_hashed(lvl) == js.level_is_hashed(lvl)
        # the decision the JAX encoder acts on
        assert ts.level_is_hashed(lvl) == _level_corner_plan(js, lvl)[4]
    if not kw:  # the INGP teacher: levels 0-4 dense, 5-13 hashed
        assert ts.table_size == 5_303_704
        assert [ts.level_is_hashed(lvl) for lvl in range(14)] == \
            [False] * 5 + [True] * 9
    else:
        assert [ts.level_is_hashed(lvl) for lvl in range(4)] == \
            [False, True, True, True]


def test_field_grid_spec_matches_jax():
    kw = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
              bound=2.0)
    js = j_hash_field.grid_spec(JModelSpec(**kw))
    ts = grid_spec(ModelSpec(**kw))
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    assert ts.desired_resolution == js.desired_resolution == 256


def test_hash_encode_plain_matches_jax():
    spec = HashGridSpec(**SMALL)
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [-1e-3, 0.5, 0.5],
             [0.5, 1.001, 0.5], [0.2, 0.3, -2.0]]  # corners, then outside
    got = hash_encode(torch.from_numpy(table), torch.from_numpy(x), spec)
    want = np.asarray(j_hash_encode(jnp.asarray(table), jnp.asarray(x),
                                    JHashGridSpec(**SMALL)))
    assert got.shape == (500, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENC_TOL)
    assert (got[3:6] == 0).all() and (got[6:].abs().sum(-1) > 0).all()


# the table gradient: one scatter-add per corner in another order than
# XLA's (which reaches the dense levels through the packed-table gather's
# autodiff), so each leaf is held to 1e-5 of its max |g|
BWD_REL_TOL = 1e-5


def _bwd_inputs(seed):
    """SMALL spec (dense level 0, hashed levels 1-3); points inside, on and
    just outside the unit cube; table and upstream gradient O(1)."""
    spec = HashGridSpec(**SMALL)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0.25, 0],
             [-1e-3, 0.5, 0.5], [0.5, 1.001, 0.5], [0.2, 0.3, -2.0],
             [1.0 + 1e-7, 0.5, 0.5]]
    g = rng.normal(size=(400, spec.output_dim)).astype(np.float32)
    return spec, table, x, g


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_encode_bwd_plain_matches_jax_vjp(seed):
    """hash_encode_bwd_plain against jax.vjp of the JAX encode
    (packed-dense default) in the table."""
    import jax

    spec, table, x, g = _bwd_inputs(seed)
    _, vjp = jax.vjp(lambda t: j_hash_encode(t, jnp.asarray(x),
                                             JHashGridSpec(**SMALL)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                spec).numpy()
    assert got.shape == want.shape == table.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=BWD_REL_TOL * scale)
    # both the dense level and the hashed levels received gradient
    offsets = spec.offsets
    for lvl in range(spec.num_levels):
        assert np.abs(got[offsets[lvl]:offsets[lvl + 1]]).sum() > 0
    # points outside the cube send nothing: their rows are all zero-weight
    only_out = hash_encode_bwd_plain(torch.from_numpy(x[4:8]),
                                     torch.from_numpy(g[4:8]), spec)
    assert not only_out.any()


def test_hash_encode_autograd_uses_the_table_gradient():
    """hash_encode is differentiable in the table (the autograd Function
    whose backward is the K7 wrapper), and refuses a position gradient."""
    spec, table, x, g = _bwd_inputs(2)
    t = torch.from_numpy(table).requires_grad_()
    xt = torch.from_numpy(x)
    out = hash_encode(t, xt, spec)
    assert out.requires_grad
    out.backward(torch.from_numpy(g))
    want = hash_encode_bwd_plain(xt, torch.from_numpy(g), spec)
    assert torch.equal(t.grad, want)
    np.testing.assert_array_equal(
        out.detach().numpy(), hash_encode_plain(t.detach(), xt, spec).numpy())
    with pytest.raises(NotImplementedError, match="positions"):
        hash_encode(t, xt.clone().requires_grad_(), spec)
    with torch.no_grad():  # no graph without grad mode
        assert not hash_encode(t, xt, spec).requires_grad


# ---- cell-packed levels (the JAX package's hash_cell_levels) -------------
# the spec of tests/test_cell_mode.py: 6 levels, base 4, desired 64, a 2^9
# table, the 2 finest hashed levels cell-packed
CELL = dict(num_levels=6, base_resolution=4, desired_resolution=64,
            log2_hashmap_size=9, n_cell_levels=2)


@pytest.mark.parametrize("kw", [CELL, dict(n_cell_levels=9)],
                         ids=["small", "ingp_default"])
def test_cell_layout_matches_jax(kw):
    js, ts = JHashGridSpec(**kw), HashGridSpec(**kw)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    assert ts.table_size == js.table_size
    assert ts.cell_levels == js.cell_levels
    assert ts.cell_rows_per_level == js.cell_rows_per_level
    assert ts.cell_table_size == js.cell_table_size
    assert ts.log2_cell_size == js.log2_cell_size
    for lvl in range(ts.num_levels):
        assert ts.is_cell_level(lvl) == js.is_cell_level(lvl)
    if kw is CELL:
        assert ts.cell_levels == [4, 5] and ts.cell_table_size == 128
    else:
        # the recipe's teacher: levels 5-13 cell-packed, a 589,824 x 16
        # cell table (37.7 MB f32) beside a 585,112 x 2 corner table
        assert ts.cell_levels == list(range(5, 14))
        assert ts.cell_table_size == 589_824 and ts.cell_row_width == 16
        assert ts.table_size == 585_112
        assert ts.offsets[5] == ts.offsets[14] == 585_112


def _cell_inputs(seed, n=400):
    spec = HashGridSpec(**CELL)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    cell = rng.uniform(-1, 1, (spec.cell_table_size, 16)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0.25, 0],
             [-1e-3, 0.5, 0.5], [0.5, 1.001, 0.5], [0.2, 0.3, -2.0],
             [1.0 + 1e-7, 0.5, 0.5]]
    g = rng.normal(size=(n, spec.output_dim)).astype(np.float32)
    return spec, table, cell, x, g


def test_cell_encode_plain_matches_jax():
    """hash_encode with a cell table equals JAX's hash_encode(...,
    cell_table=...) to 1e-5 of max |out|; outside points give 0."""
    spec, table, cell, x, _ = _cell_inputs(3)
    want = np.asarray(j_hash_encode(jnp.asarray(table), jnp.asarray(x),
                                    JHashGridSpec(**CELL),
                                    cell_table=jnp.asarray(cell)))
    got = hash_encode(torch.from_numpy(table), torch.from_numpy(x), spec,
                      torch.from_numpy(cell)).numpy()
    assert got.shape == want.shape == (400, 12)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ENC_TOL * np.abs(want).max())
    assert (got[4:7] == 0).all() and (np.abs(got[8:, 8:]).sum(-1) > 0).all()
    # the cell levels' own plain version fills columns 8:12, and the K10
    # wrapper on CPU tensors writes it into those slots alone
    np.testing.assert_array_equal(
        hash_encode_cell_plain(torch.from_numpy(cell), torch.from_numpy(x),
                               spec).numpy(), got[:, 8:])
    out = torch.full((400, 12), 7.0)
    hash_encode_cell_fwd(torch.from_numpy(cell), torch.from_numpy(x), spec,
                         out)
    assert (out[:, :8] == 7.0).all()
    np.testing.assert_array_equal(out[:, 8:].numpy(), got[:, 8:])
    with pytest.raises(ValueError, match="cell_table"):
        hash_encode(torch.from_numpy(table), torch.from_numpy(x), spec)


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_table_gradients_match_jax_vjp(seed):
    """The plain gradients of both tables against jax.vjp of the JAX
    encode, each to 1e-5 of its leaf's max."""
    import jax

    spec, table, cell, x, g = _cell_inputs(seed)
    _, vjp = jax.vjp(lambda t, c: j_hash_encode(
        t, jnp.asarray(x), JHashGridSpec(**CELL), cell_table=c),
        jnp.asarray(table), jnp.asarray(cell))
    want_t, want_c = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got_t = hash_encode_bwd_plain(xt, gt, spec).numpy()
    got_c = hash_encode_cell_bwd_plain(xt, gt, spec).numpy()
    for got, want in ((got_t, want_t), (got_c, want_c)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BWD_REL_TOL * np.abs(want).max())
    # both cell levels' blocks receive gradient; outside points send none
    rows = spec.cell_rows_per_level
    assert np.abs(got_c[:rows]).sum() > 0 and np.abs(got_c[rows:]).sum() > 0
    assert not hash_encode_cell_bwd_plain(xt[4:8], gt[4:8], spec).any()


def test_cell_encode_autograd_reaches_both_tables():
    """The autograd Function returns a gradient for each table (the K7 and
    K11 wrappers' plain versions on the CPU)."""
    spec, table, cell, x, g = _cell_inputs(2)
    t = torch.from_numpy(table).requires_grad_()
    c = torch.from_numpy(cell).requires_grad_()
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    out = hash_encode(t, xt, spec, c)
    out.backward(gt)
    assert torch.equal(t.grad, hash_encode_bwd_plain(xt, gt, spec))
    assert torch.equal(c.grad, hash_encode_cell_bwd_plain(xt, gt, spec))
    # a frozen corner table still lets the cell table train
    c.grad = None
    hash_encode(t.detach(), xt, spec, c).backward(gt)
    assert torch.equal(c.grad, hash_encode_cell_bwd_plain(xt, gt, spec))


# ---- K1's hard inputs (chip_smoke.k1_hard_inputs, which the card holds
# K1 to against the plain version) --------------------------------------
K1_N = 1031  # not a multiple of any block or tile


@functools.cache
def _k1_cases():
    return chip_smoke.k1_hard_inputs(K1_N)


def _check_k1_case(name, x, spec, levels):
    """What each case claims of its inputs and of K1's level list."""
    want = {"cell": [0, 1, 2, 3, 4], "baked": list(range(5, 14)),
            "baked_cell": [], "odd_levels": list(range(13)),
            "levels20": list(range(20)),
            "small": [0, 1, 2, 3], "one_level": [0],
            "edges_cell": [0, 1, 2, 3, 4]}.get(name, list(range(14)))
    assert levels == want
    if name in ("edges", "edges_cell"):
        nan = np.isnan(x).any(-1)
        assert nan.sum() == 4
        # a NaN beside a coordinate outside [0, 1]
        assert (nan & ((x < 0) | (x > 1)).any(-1)).sum() == 1
        assert ((x < 0) | (x > 1)).any(-1).sum() == 7
        assert ((x == 0) | (x == 1)).any(-1).sum() >= K1_N // 2
        assert (x == np.float32(1 - 2 ** -24)).sum() >= 6
        # points on a lattice plane: pos within an ulp of an integer
        on = 0
        for lv in range(spec.num_levels):
            pos = x * np.float32(spec.level_scale(lv)) + np.float32(0.5)
            on += (np.abs(pos - np.round(pos)) < 1e-4).any(-1).sum()
        assert on >= K1_N // 4
    elif name == "one_cell":  # level 0: pos = x * 15 + 0.5 in [7, 8)
        assert (np.floor(x * np.float32(15.0) + np.float32(0.5)) == 7).all()
    if name not in ("edges", "edges_cell", "one_cell"):
        steps = np.linalg.norm(np.diff(x, axis=0), axis=-1)
        assert np.median(steps) == pytest.approx(np.sqrt(3) / 1024, 1e-3)


@pytest.mark.parametrize("name", ["edges", "rays", "one_cell", "cell",
                                  "baked", "baked_cell", "odd_levels",
                                  "levels20", "small", "one_level",
                                  "edges_cell"])
def test_hash_encode_plain_matches_jax_on_k1_hard_inputs(name):
    """The plain encode (K1's plain version, with the cell levels' where
    the spec has them) against JAX's jitted `hash_encode` on its plain
    path (packed_dense off) on K1's hard inputs, to ENC_TOL; NaN where
    JAX gives NaN, including a point with a NaN coordinate and another
    outside [0, 1] (JAX and the plain version weight by w * okf); zeros
    outside the cube.  The level list K1 takes (`_levels`, with `baked`
    the corner levels a baked encode leaves) is the expected run of
    slots, and empty for the baked cell teacher."""
    import jax

    x, kw, baked = _k1_cases()[name]
    spec, jspec = HashGridSpec(**kw), JHashGridSpec(**kw)
    lv = hashgrid._levels(spec, False, baked)
    levels = list(lv.level)[:lv.n_levels]
    assert x.shape == (K1_N, 3)
    _check_k1_case(name, x, spec, levels)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    cell = (rng.uniform(-1, 1, (spec.cell_table_size, 16)).astype(np.float32)
            if spec.cell_levels else None)
    # jitted: XLA:CPU forms pos = x01 * scale + 0.5 with one FMA, as the
    # port does
    want = np.asarray(jax.jit(lambda t, xx, c: j_hash_encode(
        t, xx, jspec, packed_dense=False, cell_table=c))(
        jnp.asarray(table), jnp.asarray(x),
        None if cell is None else jnp.asarray(cell)))
    got = hash_encode_plain(torch.from_numpy(table), torch.from_numpy(x),
                            spec, None if cell is None
                            else torch.from_numpy(cell)).numpy()
    assert got.shape == want.shape == (K1_N, spec.output_dim)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=ENC_TOL)
    nan = np.isnan(x).any(-1)
    out = ((x < 0) | (x > 1)).any(-1) & ~nan
    assert np.isnan(got[nan]).all() and (got[out] == 0).all()
    assert (np.abs(got[~nan & ~out]).sum(-1) > 0).all()
