"""The pvd_tpu_torch serving slice end to end against the JAX package (CPU):
the occupancy updates (full sweep and partial) and the chunked eval
renderer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.data.poses import pose_spherical
from pvd_tpu.engine.train_steps import make_eval_renderer as j_make_eval
from pvd_tpu.engine.train_steps import make_occ_update as j_make_occ_update
from pvd_tpu.models import hash_field as j_hash_field
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.engine.train_steps import (make_eval_renderer,
                                              make_occ_update)
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import hash_field_from_jax, occupancy_from_jax
from pvd_tpu_torch.render.occupancy import init_occupancy_state

torch.set_num_threads(1)

# density grid: f32 heads on the same points, summed in another order
GRID_RTOL = 1e-4
# image and depth: the same samples (the march is exact) composited in
# another order; f32 heads
IMG_TOL = 1e-4

SPEC_KW = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
               compute_dtype="float32")
H_GRID = 32


def _assert_bits_match(occ_t, occ_j, thresh_cap=10.0):
    """Bitfields equal, except for cells whose density lies within
    GRID_RTOL of the threshold, where rounding may land either side."""
    grid = np.asarray(occ_j.density_grid).reshape(-1)
    thresh = min(float(occ_j.mean_density), thresh_cap)
    differ = occ_t.bitfield.numpy() != np.asarray(occ_j.bitfield)
    near = np.abs(grid - thresh) <= GRID_RTOL * abs(thresh) + 1e-6
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} bits"
    assert differ.sum() <= 4


def _rspec(cls, spr):
    return cls(grid_size=H_GRID, max_steps=128, samples_per_ray=spr)


@pytest.fixture(scope="module")
def field_params():
    """JAX init, then an O(1) table so the density grid has structure."""
    params = jax.tree_util.tree_map(
        np.asarray, j_hash_field.init(jax.random.PRNGKey(3),
                                      JModelSpec(**SPEC_KW)))
    rng = np.random.default_rng(3)
    params["encoder"] = rng.uniform(-1, 1, params["encoder"].shape) \
        .astype(np.float32)
    return params


@pytest.fixture(scope="module")
def swept(field_params):
    """One full sweep on each side, from the same jitter."""
    spec_j, rspec_j = JModelSpec(**SPEC_KW), _rspec(JRenderSpec, 1.0)
    key = jax.random.PRNGKey(5)
    occ_j = j_make_occ_update(spec_j, rspec_j)(
        j_init_occ(rspec_j), jax.tree_util.tree_map(jnp.asarray,
                                                    field_params), key,
        full=True)
    # the JAX sweep's jitter: uniform(fold_in(key, cas), (H^3, 3))
    jitter = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, cas), (H_GRID ** 3, 3)))
        for cas in range(rspec_j.cascades)])
    spec_t, rspec_t = ModelSpec(**SPEC_KW), _rspec(RenderSpec, 1.0)
    field = hash_field_from_jax(field_params, spec_t, "cpu")
    occ_t = make_occ_update(spec_t, rspec_t, device="cpu")(
        init_occupancy_state(rspec_t, "cpu"), field, full=True,
        jitter=torch.from_numpy(jitter))
    return occ_j, occ_t, field


def test_full_sweep_matches_jax(swept):
    occ_j, occ_t, _ = swept
    grid_j = np.asarray(occ_j.density_grid)
    np.testing.assert_allclose(occ_t.density_grid.numpy(), grid_j,
                               rtol=GRID_RTOL, atol=1e-6)
    np.testing.assert_allclose(float(occ_t.mean_density),
                               float(occ_j.mean_density), rtol=1e-5)
    bits_j = np.asarray(occ_j.bitfield)
    assert 0.05 < bits_j.mean() < 0.95
    _assert_bits_match(occ_t, occ_j)
    assert occ_t.iter_density == int(occ_j.iter_density) == 1


def test_partial_update_matches_jax(field_params, swept):
    """Partial mode from the swept state: the JAX package's cells (uniform
    plus inverse-CDF resampled occupied ones) and jitter, regenerated from
    its key as occupancy.py:280-297 draws them, go to the port."""
    occ_j, _, field = swept
    spec_j, rspec_j = JModelSpec(**SPEC_KW), _rspec(JRenderSpec, 1.0)
    key = jax.random.PRNGKey(9)
    new_j = j_make_occ_update(spec_j, rspec_j)(
        occ_j, jax.tree_util.tree_map(jnp.asarray, field_params), key,
        full=False)
    H, n = H_GRID, H_GRID ** 3 // 4
    coords, jitter = [], []
    for cas in range(rspec_j.cascades):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, cas), 3)
        rand = jax.random.randint(k1, (n, 3), 0, H)
        cdf = jnp.cumsum((occ_j.density_grid[cas].reshape(-1) > 0)
                         .astype(jnp.float32))
        u = jax.random.uniform(k2, (n,)) * jnp.maximum(cdf[-1], 1.0)
        flat = jnp.clip(jnp.searchsorted(cdf, u, side="left"), 0, H ** 3 - 1)
        occd = jnp.stack([flat // (H * H), (flat // H) % H, flat % H], -1)
        occd = jnp.where(cdf[-1] > 0, occd, rand)
        coords.append(np.asarray(jnp.concatenate([rand, occd])))
        jitter.append(np.asarray(jax.random.uniform(k3, (2 * n, 3))))
    spec_t, rspec_t = ModelSpec(**SPEC_KW), _rspec(RenderSpec, 1.0)
    new_t = make_occ_update(spec_t, rspec_t, device="cpu")(
        occupancy_from_jax(occ_j, "cpu"), field, full=False,
        jitter=torch.from_numpy(np.stack(jitter)),
        coords=torch.from_numpy(np.stack(coords)))
    np.testing.assert_allclose(new_t.density_grid.numpy(),
                               np.asarray(new_j.density_grid),
                               rtol=GRID_RTOL, atol=1e-6)
    _assert_bits_match(new_t, new_j)
    assert new_t.iter_density == 2
    # the update touched cells (EMA-max) but not all of them
    moved = new_t.density_grid.numpy() != np.asarray(occ_j.density_grid)
    assert 0.05 < moved.mean() < 0.95


def test_eval_render_matches_jax(field_params, swept):
    """An 18x16 image at chunk 64: four full chunks and a padded tail.  A
    budget of 12 samples per ray (768 slots per chunk) is below the ~35
    valid samples per ray here, so chunks retry on the budget ladder."""
    occ_j, _, field = swept
    H, W, intr = 18, 16, (10.0, 10.0, 8.0, 8.0)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0))
    spec_j, rspec_j = JModelSpec(**SPEC_KW), _rspec(JRenderSpec, 12.0)
    img_j, dep_j = j_make_eval(spec_j, rspec_j, chunk=64)(
        jax.tree_util.tree_map(jnp.asarray, field_params), occ_j, pose, intr,
        H, W)
    spec_t, rspec_t = ModelSpec(**SPEC_KW), _rspec(RenderSpec, 12.0)
    out = make_eval_renderer(spec_t, rspec_t, chunk=64, device="cpu")(
        field, occupancy_from_jax(occ_j, "cpu"), pose, intr, H, W)
    assert out.image.shape == (H, W, 3) and out.depth.shape == (H, W)
    assert out.rungs >= 2, "the 1x budget must overflow at least once"
    assert out.truncated_chunks == 0
    assert float(out.weights_sum.max()) > 0.1
    assert 0.2 < float(np.asarray(img_j).mean()) < 0.99
    np.testing.assert_allclose(out.image.numpy(), np.asarray(img_j),
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(dep_j),
                               rtol=0, atol=IMG_TOL)
