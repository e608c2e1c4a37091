"""pvd_tpu_torch hash grid against the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.models import hash_field as j_hash_field
from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.ops.hashgrid import HashGridSpec as JHashGridSpec
from pvd_tpu.ops.hashgrid import _level_corner_plan
from pvd_tpu.ops.hashgrid import hash_encode as j_hash_encode
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.hash_field import grid_spec
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
