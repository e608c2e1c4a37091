"""pvd_tpu_torch primitives and heads against the JAX package (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.models import hash_field as j_hash_field
from pvd_tpu.models.common import apply_mlp as j_apply_mlp
from pvd_tpu.models.heads import shared_density as j_shared_density
from pvd_tpu.models.heads import shared_sigma_color as j_shared_sigma_color
from pvd_tpu.ops.aabb import near_far_from_aabb as j_near_far
from pvd_tpu.ops.activation import trunc_exp as j_trunc_exp
from pvd_tpu.ops.rays import get_rays as j_get_rays
from pvd_tpu.ops.rays import nerf_matrix_to_ngp as j_nerf_matrix_to_ngp
from pvd_tpu.ops.rays import pixel_dirs as j_pixel_dirs
from pvd_tpu.ops.sh import sh_encode as j_sh_encode
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.models.common import apply_mlp, make_mlp
from pvd_tpu_torch.models.heads import shared_density, shared_sigma_color
from pvd_tpu_torch.ops.aabb import FLT_MAX, near_far_from_aabb
from pvd_tpu_torch.ops.activation import trunc_exp
from pvd_tpu_torch.ops.rays import get_rays, nerf_matrix_to_ngp, pixel_dirs
from pvd_tpu_torch.ops.sh import sh_encode
from pvd_tpu_torch.params import hash_field_from_jax

torch.set_num_threads(1)

F32_TOL = 1e-5  # f32 elementwise/matmul; summation order differs from XLA
# bf16 heads: inputs and every layer output round to 8 mantissa bits, at
# other places in XLA than in PyTorch; outputs are O(1)
BF16_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_near_far_hits_and_misses():
    rng = np.random.default_rng(0)
    n = 64
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    o[:4] = [[0.0, 0.0, -3.0]] * 4  # straight at the box
    d[:4] = [[0.0, 0.0, 1.0]] * 4
    o[4:8] = [[3.0, 3.0, 0.0]] * 4  # parallel to it, outside
    d[4:8] = [[0.0, 0.0, 1.0]] * 4
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nj, fj = j_near_far(o, d, jnp.asarray(aabb), 0.2)
    nt, ft = near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.2)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert (nt[4:8] == FLT_MAX).all() and (ft[4:8] == FLT_MAX).all()
    assert (nt[:4] == 2.0).all() and (nt >= 0.2).all()
    assert 4 < int((nt < FLT_MAX).sum()) < n


def test_pixel_dirs_and_full_image_rays():
    from pvd_tpu.data.poses import pose_spherical

    H, W, intr = 12, 16, (11.0, 13.0, 8.0, 6.0)
    inds = np.arange(H * W, dtype=np.int32)
    dj = j_pixel_dirs(intr, jnp.asarray(inds), H, W)  # eager, as traced
    dt = pixel_dirs(intr, _t(inds), H, W)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    pose = j_nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0))
    np.testing.assert_array_equal(
        nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0)), pose)
    rj = jax.jit(lambda p: j_get_rays(None, p, intr, H, W))(pose[None])
    rt = get_rays(_t(pose[None]), intr, H, W)
    np.testing.assert_array_equal(rt["rays_o"].numpy(),
                                  np.asarray(rj["rays_o"]))
    # the batched einsum's contraction order differs from the eval
    # renderer's `dirs @ R.T` (which `rotate` reproduces exactly) in a few
    # rows: 1 ulp
    np.testing.assert_allclose(rt["rays_d"].numpy(), np.asarray(rj["rays_d"]),
                               rtol=0, atol=2.5e-7)


def test_trunc_exp_value_and_grad():
    x = np.linspace(-20, 20, 81).astype(np.float32)
    gj = jax.grad(lambda v: j_trunc_exp(v).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6)
    # the derivative is clamped at |x| > 12
    assert float(xt.grad[-1]) == pytest.approx(float(np.exp(np.float32(12))),
                                               rel=1e-6)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(degree):
    d = _unit(np.random.default_rng(degree), 200)
    np.testing.assert_allclose(sh_encode(_t(d), degree).numpy(),
                               np.asarray(j_sh_encode(jnp.asarray(d), degree)),
                               rtol=1e-5, atol=F32_TOL)


def _mlp_tree(rng, dims):
    return [{"w": rng.uniform(-1, 1, (i, o)).astype(np.float32) / np.sqrt(i)}
            for i, o in zip(dims[:-1], dims[1:])]


def _load(layers, tree):
    with torch.no_grad():
        for lin, p in zip(layers, tree):
            lin.weight.copy_(_t(p["w"].T))


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_apply_mlp(final):
    rng = np.random.default_rng(1)
    dims = [28, 64, 64, 16]
    tree = _mlp_tree(rng, dims)
    x = rng.normal(size=(100, 28)).astype(np.float32)
    layers = make_mlp(dims)
    _load(layers, tree)
    with torch.no_grad():
        got = apply_mlp(layers, _t(x), final).numpy()
    want = np.asarray(j_apply_mlp(tree, jnp.asarray(x), final))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heads(dtype):
    kw = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
              compute_dtype=dtype)
    spec_j, spec_t = JModelSpec(**kw), ModelSpec(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, j_hash_field.init(jax.random.PRNGKey(0), spec_j))
    field = hash_field_from_jax(params, spec_t, "cpu")
    rng = np.random.default_rng(2)
    enc = rng.normal(scale=2.0, size=(300, 8)).astype(np.float32)
    d = _unit(rng, 300)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with torch.no_grad():
        ot = shared_sigma_color(field, spec_t, _t(enc), _t(d), True)
        dens_t = shared_density(field, spec_t, _t(enc))
    oj = j_shared_sigma_color(params, spec_j, jnp.asarray(enc),
                              jnp.asarray(d), True)
    for name in ("sigma_logit", "fea_sc", "rgb"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)), rtol=tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(ot.sigma.numpy(), np.asarray(oj.sigma),
                               rtol=tol, atol=tol)
    # the density path runs in f32 whatever compute_dtype says
    np.testing.assert_allclose(
        dens_t.numpy(), np.asarray(j_shared_density(params, spec_j,
                                                    jnp.asarray(enc))),
        rtol=1e-5, atol=F32_TOL)
    stage1 = shared_sigma_color(field, spec_t, _t(enc), _t(d), False)
    assert stage1.rgb is None and stage1.fea_sc.shape == (300, 16)
