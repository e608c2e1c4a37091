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
