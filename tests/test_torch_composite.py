"""pvd_tpu_torch compositing against the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.ops.composite import composite_rays as j_composite_rays
from pvd_tpu.ops.composite import composite_rays_compact as j_compact_comp
from pvd_tpu.render.renderer import compact_samples as j_compact
from pvd_tpu_torch.ops.composite import (composite_rays,
                                         composite_rays_compact)

torch.set_num_threads(1)

# transmittance is a product in another association order than the JAX
# package's associative_scan, and the per-ray sums run in another order
COMP_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream(seed, n_rays=30, s=20, budget=256):
    """A compacted eval stream (prefix=False): valid prefix in ray order,
    then an invalid tail whose ray_id is 0."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(n_rays, s)) < 0.35
    mask[::6] = False
    c = j_compact(jnp.asarray(mask), budget, prefix=False)
    M = budget
    # densities spanning empty space to opaque: alpha = 1 happens
    sig = rng.choice([0.0, 0.5, 5.0, 80.0, 1e4], size=M).astype(np.float32)
    sig *= rng.uniform(0.5, 1.5, M).astype(np.float32)
    rgb = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    valid = np.asarray(c.valid)
    dt = np.where(valid, np.float32(2 * np.sqrt(3) / 128), 0).astype(
        np.float32)
    t_cum = np.where(valid, rng.uniform(0.2, 3.0, M), 0).astype(np.float32)
    return sig, rgb, dt, t_cum, np.asarray(c.ray_id), valid, n_rays


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_compact_matches_jax(early_stop, seed):
    sig, rgb, dt, t_cum, rid, valid, n = _stream(seed)
    assert not valid[-1] and rid[-1] == 0  # the zero ray_id tail
    want = j_compact_comp(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dt),
                          jnp.asarray(t_cum), jnp.asarray(rid),
                          jnp.asarray(valid), n, early_stop=early_stop)
    got = composite_rays_compact(_t(sig), _t(rgb), _t(dt), _t(t_cum),
                                 _t(rid).long(), _t(valid), n,
                                 early_stop=early_stop)
    for g, w, name in zip(got, want, ("weights_sum", "depth", "image",
                                      "weights")):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=COMP_TOL,
                                   atol=COMP_TOL, err_msg=name)
    ws = got[0].numpy()
    assert ws.max() > 0.99 and (ws == 0).any()


@pytest.mark.parametrize("early_stop", [False, True])
def test_composite_padded_matches_jax(early_stop):
    rng = np.random.default_rng(4)
    N, S = 16, 24
    mask = rng.uniform(size=(N, S)) < 0.6
    sig = rng.choice([0.0, 3.0, 50.0, 1e4], size=(N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    dt = np.full((N, S), 0.027, np.float32)
    dd = rng.uniform(0.01, 0.1, (N, S)).astype(np.float32)
    want = j_composite_rays(*(jnp.asarray(a) for a in (sig, rgb, dt, dd,
                                                       mask)),
                            early_stop=early_stop)
    got = composite_rays(*(_t(a) for a in (sig, rgb, dt, dd, mask)),
                         early_stop=early_stop)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=COMP_TOL,
                                   atol=COMP_TOL)
