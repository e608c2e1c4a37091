"""pvd_tpu_torch march and compaction against the JAX package (CPU).

The plain march must give the JAX package's t, dt and mask exactly and
delta_depth within 1e-6 (the same f32 ops in the same order), in eval and
train mode, with and without a perturbation, at one and two cascades.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.ops.aabb import near_far_from_aabb as j_near_far
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu.render.renderer import compact_samples as j_compact
from pvd_tpu.render.renderer import march_rays as j_march
from pvd_tpu_torch.config import RenderSpec
from pvd_tpu_torch.render.renderer import compact_samples, march_rays

torch.set_num_threads(1)

DD_TOL = 1e-6  # delta_depth: u - prev, same ops; allowance for ulp drift
H, STEPS, S_TRAIN = 32, 128, 32


def _rays(rng, n, bound):
    """Rays from a sphere around the box, aimed near the center; an eighth
    point away from it and an eighth pass beside it (those miss the box:
    near = far = FLT_MAX)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = -2.6 * bound * dirs
    d = dirs + rng.normal(scale=0.15, size=(n, 3))
    d[6 * n // 8: 7 * n // 8] *= -1.0
    side = np.cross(dirs, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    o[7 * n // 8:] += 2.5 * bound * side[7 * n // 8:]
    d[7 * n // 8:] = dirs[7 * n // 8:]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _case(bound, s_max, seed):
    rspec_j = JRenderSpec(bound=bound, grid_size=H, max_steps=STEPS,
                          max_samples=s_max)
    rspec_t = RenderSpec(bound=bound, grid_size=H, max_steps=STEPS,
                         max_samples=s_max)
    rng = np.random.default_rng(seed)
    C = rspec_j.cascades
    bitfield = rng.uniform(size=C * H ** 3) < 0.3
    o, d = _rays(rng, 48, bound)
    aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
    nears, fars = (np.asarray(a) for a in j_near_far(o, d, aabb, 0.2))
    assert (nears >= 3e38).sum() >= 4, "some rays must miss"
    return rspec_j, rspec_t, bitfield, o, d, nears, fars


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_march(rspec_t, bitfield, o, d, nears, fars, u=None):
    return march_rays(_t(bitfield), _t(o), _t(d), _t(nears), _t(fars),
                      rspec_t, None if u is None else _t(u))


def _assert_same(sj, st):
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))
    np.testing.assert_array_equal(st.dt.numpy(), np.asarray(sj.dt))
    np.testing.assert_array_equal(st.t0.numpy(), np.asarray(sj.t0))
    np.testing.assert_allclose(st.delta_depth.numpy(),
                               np.asarray(sj.delta_depth), rtol=0,
                               atol=DD_TOL)


@pytest.mark.parametrize("bound", [1.0, 2.0])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("perturb", [False, True])
def test_march_plain_matches_jax(bound, mode, perturb):
    s_max = STEPS if mode == "eval" else S_TRAIN
    rspec_j, rspec_t, bitfield, o, d, nears, fars = _case(bound, s_max, 3)
    key, u = None, None
    if perturb:
        key = jax.random.PRNGKey(11)
        u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    sj = jax.jit(lambda *a: j_march(*a, rspec_j, key))(
        jnp.asarray(bitfield), o, d, nears, fars)
    st = _torch_march(rspec_t, bitfield, o, d, nears, fars, u)
    assert st.mask.sum() > 100
    _assert_same(sj, st)
    miss = nears >= 3e38
    assert not st.mask.numpy()[miss].any()
    assert np.isfinite(st.delta_depth.numpy()).all()


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_march_plain_matches_jax_probe_path(mode):
    """One cascade: JAX's default path marches through the supercell probe
    masks that set_bitfield builds; the samples are the same."""
    s_max = STEPS if mode == "eval" else S_TRAIN
    rspec_j, rspec_t, bitfield, o, d, nears, fars = _case(1.0, s_max, 5)
    occ = j_set_bitfield(j_init_occ(rspec_j), jnp.asarray(bitfield))
    sj = jax.jit(lambda *a: j_march(*a, rspec_j,
                                    neighbor_masks=occ.neighbor_masks))(
        occ.bitfield, o, d, nears, fars)
    st = _torch_march(rspec_t, bitfield, o, d, nears, fars)
    _assert_same(sj, st)


def test_march_rejects_dt_gamma():
    rspec = RenderSpec(grid_size=H, max_steps=STEPS, dt_gamma=1 / 256)
    o = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError):
        march_rays(torch.zeros(H ** 3, dtype=torch.bool), o, o + 1,
                   torch.ones(2), torch.ones(2), rspec)


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("budget", [128, 256, 1024])
def test_compact_samples_matches_jax(prefix, budget):
    rng = np.random.default_rng(budget)
    N, S = 40, 24
    if prefix:  # per-row prefixes, as a train-mode march gives
        cnt = rng.integers(0, S + 1, N)
        cnt[::7] = 0
        mask = np.arange(S)[None, :] < cnt[:, None]
    else:
        mask = rng.uniform(size=(N, S)) < 0.4
        mask[::5] = False
    cj = j_compact(jnp.asarray(mask), budget, prefix=prefix)
    ct = compact_samples(_t(mask), budget, prefix=prefix)
    for name in ("idx", "valid", "ray_id", "total"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)),
                                      err_msg=name)
    # the cases cover both an over-budget and an under-budget batch
    assert int(ct.total) > 128 and (budget != 1024 or int(ct.total) < budget)
