"""The corner table's gradient (K7's plain version) against the JAX
package's VJP on K7's hard inputs (CPU).

chip_smoke.py's `k7_hard_inputs` are the inputs the card holds K7 to
against `hash_encode_bwd_plain`: a warp's points in one cell, ray-major
runs, upstream rows zero at some levels, points on and outside the cube's
faces, a padded stream, the cell-mode level list, two cells whose corner-0
hashed rows collide and a grid with an odd number of levels.  Here the
plain version is held to `jax.vjp` of the JAX package's `hash_encode` in
the table on the same inputs, at the INGP grid (14 levels, 2^19 rows), its
cell-mode layout and a 13-level grid, to 1e-5 of the
gradient's max |g| (scatter-adds in another order than XLA's, which
reaches the dense levels through the packed-table gather's autodiff).
JAX runs jitted, so its lattice positions take the port's FMA.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pvd_tpu.ops.hashgrid import HashGridSpec as JHashGridSpec
from pvd_tpu.ops.hashgrid import hash_encode as j_hash_encode
from pvd_tpu_torch.ops.hashgrid import (HashGridSpec, hash_encode_bwd,
                                        hash_encode_bwd_plain,
                                        level_corners)

torch.set_num_threads(1)

BWD_REL_TOL = 1e-5
N = 4096


@functools.cache
def _cases():
    return chip_smoke.k7_hard_inputs(N)


def _check_case(name, x, g, spec):
    """What each case claims of its inputs."""
    if name == "one_cell":  # level 0: pos = x * 15 + 0.5 in [7, 8)
        assert (np.floor(x * np.float32(15.0) + np.float32(0.5)) == 7).all()
    elif name == "g_levels":
        gl = g.reshape(N, -1, 2)
        assert not gl[:, [2, 9]].any()
        assert 0.4 < (np.abs(gl).sum(-1) == 0).mean() < 0.6
    elif name == "edge":
        assert ((x == 0) | (x == 1)).any(-1).sum() >= N // 2
        assert ((x < 0) | (x > 1)).any(-1).sum() == 8
        assert (np.abs(g).sum(-1) == 0).sum() == -(-N // 3)
    elif name == "padded":
        assert (np.abs(g).sum(-1) == 0).mean() == pytest.approx(29 / 32)
    elif name == "cell_levels":
        assert spec.corner_levels == [0, 1, 2, 3, 4]
    elif name == "collision":
        # lanes alternate between two level-5 cells whose corner-0 rows
        # collide while another corner's rows differ
        base = np.floor(x * np.float32(spec.level_scale(5)) + np.float32(0.5))
        assert (base[0::2] == base[0]).all() and (base[1::2] == base[1]).all()
        assert (base[0] != base[1]).any()
        _, rows = level_corners(torch.from_numpy(x[:2]), spec, 5)
        assert spec.level_is_hashed(5) and rows[0, 0] == rows[0, 1]
        assert (rows[1:, 0] != rows[1:, 1]).any()
    elif name == "odd_levels":
        assert spec.num_levels % 2 == 1 and not spec.cell_levels
    if name in ("rays", "g_levels", "padded", "cell_levels", "odd_levels"):
        # ray-major runs: neighbouring points a march step apart
        steps = np.linalg.norm(np.diff(x, axis=0), axis=-1)
        assert np.median(steps) == pytest.approx(np.sqrt(3) / 1024, 1e-3)


@pytest.mark.parametrize("name", ["one_cell", "rays", "g_levels", "edge",
                                  "padded", "cell_levels", "collision",
                                  "odd_levels"])
def test_hash_encode_bwd_plain_matches_jax_vjp(name):
    x, g, kw = _cases()[name]
    spec, jspec = HashGridSpec(**kw), JHashGridSpec(**kw)
    assert x.shape == (N, 3) and g.shape == (N, spec.output_dim)
    _check_case(name, x, g, spec)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    cell = (rng.uniform(-1, 1, (spec.cell_table_size, 16)).astype(np.float32)
            if spec.cell_levels else None)
    # jitted: XLA:CPU then forms pos = x01 * scale + 0.5 with one FMA, as
    # the port does (eager JAX rounds the product first, which moves a
    # fine level's corner weights by ~1e-4)

    @jax.jit
    def table_vjp(t, x01, c, gg):
        return jax.vjp(lambda t: j_hash_encode(t, x01, jspec, cell_table=c),
                       t)[1](gg)[0]

    want = np.asarray(table_vjp(jnp.asarray(table), jnp.asarray(x),
                                None if cell is None else jnp.asarray(cell),
                                jnp.asarray(g)))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = hash_encode_bwd_plain(xt, gt, spec).numpy()
    assert got.shape == want.shape == table.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BWD_REL_TOL * np.abs(want).max())
    # every corner level with an upstream gradient receives some
    gl = g.reshape(N, -1, 2)
    for lv in spec.corner_levels:
        block = got[spec.offsets[lv]:spec.offsets[lv + 1]]
        assert (np.abs(block).sum() > 0) == bool(np.abs(gl[:, lv]).sum())
    # the K7 wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(hash_encode_bwd(xt, gt, spec).numpy(), got)
