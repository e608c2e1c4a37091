"""pvd_tpu_torch's stratified renderer against the JAX package (CPU):
`ops/sampling.py` (linspace_f32, stratified_z_vals, sample_pdf),
`ops/composite.composite_stratified` and `render/renderer.render_stratified`.

Inputs come from numpy generators with fixed seeds; the random draws are
the JAX package's own, regenerated from its keys (`jax.random.split(rng)`
-> k_strat, k_pdf; `uniform(k_strat, [N, num_steps])`, `uniform(k_pdf,
[N, upsample_steps])`) and handed to the port, which never draws them
itself here.  The JAX functions run eagerly (op by op, as the JAX tests
call them); fields are float32.

Tolerances:
  * linspace_f32 and stratified_z_vals: exact (the same float32 ops; the
    linspace's FMAs reproduced);
  * sample_pdf: 2e-5 absolute on z in [0, 4] (the pdf's normaliser and
    the CDF's running sum add in another order than XLA's, and a few ulps
    of CDF move a sample by the bin's width over its CDF rise times that;
    a u within an ulp of a CDF step may fall in the next bin, where the
    interpolation meets the same z);
  * composite_stratified: 1e-6 x max |value| and 1e-5 x max |gradient|
    (products and sums over 64 samples in another order);
  * render_stratified: image, depth and weights_sum within 1e-5, field
    gradients within 1e-4 x each leaf's max |g| (the hash encode's
    plain version rounds x01 * scale + 0.5 as XLA:CPU's jitted encode,
    one ulp from the eager one at some points, and the sums run in
    another order; a point a rounding error from a lattice cell face
    would pick other corners, none does at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.ops.composite import composite_stratified as j_composite
from pvd_tpu.ops.sampling import sample_pdf as j_sample_pdf
from pvd_tpu.ops.sampling import stratified_z_vals as j_z_vals
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu.render.renderer import render_rays as j_render_rays
from pvd_tpu.render.renderer import render_stratified as j_render_stratified
from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.ops.composite import composite_stratified
from pvd_tpu_torch.ops.sampling import (linspace_f32, sample_pdf,
                                        stratified_z_vals)
from pvd_tpu_torch.params import field_from_tree, tree_from_field
from pvd_tpu_torch.render.occupancy import init_occupancy_state, set_bitfield
from pvd_tpu_torch.render.renderer import render_rays, render_stratified

torch.set_num_threads(1)

PDF_ATOL = 2e-5
COMP_RTOL, COMP_GRAD_RTOL = 1e-6, 1e-5
IMG_TOL, GRAD_RTOL = 1e-5, 1e-4

HASH_KW = dict(model_type="hash", hash_num_levels=4, hash_log2_size=14,
               hash_desired_res=64, compute_dtype="float32")
VM_KW = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=6,
             vm_resolution=(12, 14, 16), compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.mark.parametrize("n", [2, 16, 17, 33, 64, 128, 256, 512])
def test_linspace_matches_jnp(n):
    np.testing.assert_array_equal(linspace_f32(0.0, 1.0, n).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, n)))
    if n & (n - 1) == 0:  # sample_pdf's deterministic quantiles
        a, b = 0.5 / n, 1.0 - 0.5 / n
        np.testing.assert_array_equal(linspace_f32(a, b, n).numpy(),
                                      np.asarray(jnp.linspace(a, b, n)))


def _near_far(rng, n):
    nears = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return nears, (nears + rng.uniform(0.5, 2.0, n)).astype(np.float32)


@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_z_vals_match_jax(perturb):
    nears, fars = _near_far(np.random.default_rng(0), 7)
    key = jax.random.PRNGKey(3)
    zj, sdj = j_z_vals(key, jnp.asarray(nears), jnp.asarray(fars), 64,
                       perturb)
    u = np.asarray(jax.random.uniform(key, (7, 64)))
    zt, sdt = stratified_z_vals(_t(nears), _t(fars), 64, perturb, u=_t(u))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(sdt.numpy(), np.asarray(sdj))


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(1)
    N, T, S = 9, 33, 64
    bins = np.sort(rng.uniform(0.0, 4.0, (N, T)), axis=-1).astype(np.float32)
    w = rng.exponential(1.0, (N, T - 1)).astype(np.float32)
    w[:3, 10:20] *= 50.0  # peaked rays
    w[3, :] = 0.0  # a ray without weight: the 1e-5 floor decides
    key = jax.random.PRNGKey(7)
    zj = np.asarray(j_sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), S,
                                 det=det))
    u = None if det else _t(jax.random.uniform(key, (N, S)))
    zt = sample_pdf(_t(bins), _t(w), S, det=det, u=u).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=PDF_ATOL)
    assert (zt >= bins[:, :1]).all() and (zt <= bins[:, -1:]).all()


def test_composite_stratified_values_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    N, T = 6, 64
    nears, fars = _near_far(rng, N)
    z, sd = stratified_z_vals(_t(nears), _t(fars), T, True,
                              u=_t(rng.uniform(size=(N, T))))
    sig = rng.exponential(3.0, (N, T)).astype(np.float32)
    sig[0] = 0.0  # an empty ray
    sig[1, 5] = 1e4  # an opaque sample
    rgb = rng.uniform(size=(N, T, 3)).astype(np.float32)
    gw = rng.normal(size=(N,)).astype(np.float32)
    gi = rng.normal(size=(N, 3)).astype(np.float32)

    def j_loss(s, c):
        ws, _, img = j_composite(s, jnp.asarray(z.numpy()),
                                 jnp.asarray(sd.numpy()), c)
        return jnp.sum(ws * gw) + jnp.sum(img * gi), (ws, img)

    (_, (wsj, imgj)), (gsj, gcj) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(sig),
                                              jnp.asarray(rgb))
    st, ct = _t(sig).requires_grad_(), _t(rgb).requires_grad_()
    wst, weights, imgt = composite_stratified(st, z, sd, ct)
    ((wst * _t(gw)).sum() + (imgt * _t(gi)).sum()).backward()
    assert weights.shape == (N, T)
    for got, want, rtol in ((wst, wsj, COMP_RTOL), (imgt, imgj, COMP_RTOL),
                            (st.grad, gsj, COMP_GRAD_RTOL),
                            (ct.grad, gcj, COMP_GRAD_RTOL)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=rtol * np.abs(want).max())


def _params(kw, bg: bool, seed: int = 4):
    """JAX init, then O(1) tables so the field has structure."""
    spec = JModelSpec(**kw, bg_radius=8.0 if bg else -1.0)
    tree = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)
    if kw["model_type"] == "hash":
        tree["encoder"] = rng.uniform(-1, 1, tree["encoder"].shape) \
            .astype(np.float32)
    else:
        for k in ("sigma_mat", "sigma_vec", "color_mat", "color_vec"):
            tree[k] = [rng.uniform(-1, 1, a.shape).astype(np.float32)
                       for a in tree[k]]
    if bg:
        tree["bg"]["encoder"] = rng.uniform(
            -1, 1, tree["bg"]["encoder"].shape).astype(np.float32)
    return tree


def _rays(rng, n):
    """Rays from outside the unit box toward points inside it, and one
    that misses it (the JAX package renders such a ray over [0, 1] with
    its points clipped onto the box, so it need not be empty)."""
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    o[:, 2] = -2.5
    target = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[-1], d[-1] = [3.0, 3.0, -2.5], [0.0, 0.0, 1.0]  # misses the box
    return o, d.astype(np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("kw,upsample,bg,perturb", [
    (HASH_KW, 0, False, True), (HASH_KW, 16, False, False),
    (HASH_KW, 16, False, True), (HASH_KW, 0, True, True),
    (HASH_KW, 16, True, True), (VM_KW, 16, False, True)],
    ids=["hash-up0", "hash-up16-det", "hash-up16", "hash-up0-bg",
         "hash-up16-bg", "vm-up16"])
def test_render_stratified_matches_jax(kw, upsample, bg, perturb):
    """Images, depths, weights_sum and every field gradient of a weighted
    sum of image and depth, against jax.grad."""
    N, T = 12, 48
    tree = _params(kw, bg)
    aabb = np.array([-1.0, -1, -1, 1, 1, 1], np.float32)
    o, d = _rays(np.random.default_rng(5), N)
    rng = np.random.default_rng(6)
    gi = rng.normal(size=(N, 3)).astype(np.float32)
    gd = rng.normal(size=(N,)).astype(np.float32)
    rspec_kw = dict(num_steps=T, upsample_steps=upsample)
    spec_j = JModelSpec(**kw, bg_radius=8.0 if bg else -1.0)
    key = jax.random.PRNGKey(11) if perturb else None

    def j_loss(params):
        out = j_render_stratified(
            params, spec_j, JRenderSpec(**rspec_kw), jnp.asarray(aabb),
            jnp.asarray(o), jnp.asarray(d), rng=key, perturb=perturb)
        return (jnp.sum(out["image"] * gi) + jnp.sum(out["depth"] * gd),
                out)

    (_, out_j), g_j = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    draws = None
    if perturb:
        k_strat, k_pdf = jax.random.split(key)
        draws = (_t(jax.random.uniform(k_strat, (N, T))),
                 _t(jax.random.uniform(k_pdf, (N, upsample)))
                 if upsample else None)
    spec_t = ModelSpec(**kw, bg_radius=8.0 if bg else -1.0)
    field = field_from_tree(tree, spec_t, "cpu")
    out_t = render_stratified(field, spec_t, RenderSpec(**rspec_kw),
                              _t(aabb), _t(o), _t(d), perturb=perturb,
                              draws=draws)
    ((out_t["image"] * _t(gi)).sum()
     + (out_t["depth"] * _t(gd)).sum()).backward()
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=0,
                                   atol=IMG_TOL, err_msg=k)
    ws = out_t["weights_sum"].detach().numpy()
    assert 0.0 <= ws.min() and 0.0 < ws.max() <= 1.0
    g_t = tree_from_field(field, grad=True)
    for path, want in _leaves(g_j):
        got = _get(g_t, path)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max()
                                   + 1e-12, err_msg=str(path))


def test_render_stratified_draws_from_a_generator():
    """With a generator the samples are jittered and resampled at random:
    two generators seeded alike give the same render, another seed
    another one; without one the render is deterministic."""
    spec = ModelSpec(**HASH_KW)
    field = field_from_tree(_params(HASH_KW, False), spec, "cpu")
    rspec = RenderSpec(num_steps=32, upsample_steps=8)
    aabb = _t([-1.0, -1, -1, 1, 1, 1])
    o, d = (_t(a) for a in _rays(np.random.default_rng(5), 6))

    def render(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return render_stratified(field, spec, rspec, aabb, o, d,
                                     generator=gen, perturb=True)["image"]

    assert torch.equal(render(1), render(1))
    assert not torch.equal(render(1), render(2))
    assert torch.equal(render(None), render(None))
    assert not torch.equal(render(None), render(1))


def test_render_stratified_matches_the_grid_path_roughly():
    """As the JAX package's test_renderer: with a fully occupied grid and
    a dense lattice both paths see the same field, and the images agree
    to a few 1e-2 (different sampling); the port's stratified image also
    equals JAX's."""
    kw = dict(model_type="hash", hash_num_levels=4, hash_desired_res=64,
              compute_dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(0), JModelSpec(**kw)))
    rs_kw = dict(bound=1.0, grid_size=32, max_steps=256, max_samples=256,
                 num_steps=256)
    o = np.array([[0.0, 0, -2.0], [0.05, 0.05, -2.0]], np.float32)
    d = np.array([[0.0, 0, 1.0], [0.0, 0, 1.0]], np.float32)
    spec, rspec = ModelSpec(**kw), RenderSpec(**rs_kw)
    field = field_from_tree(tree, spec, "cpu")
    occ = init_occupancy_state(rspec, "cpu")
    occ = set_bitfield(occ, torch.ones_like(occ.bitfield))
    with torch.no_grad():
        img_g = render_rays(field, spec, rspec, occ, _t(o), _t(d),
                            training=False)["image"]
        img_s = render_stratified(field, spec, rspec, occ.aabb_infer,
                                  _t(o), _t(d))["image"]
    np.testing.assert_allclose(img_g.numpy(), img_s.numpy(), atol=0.05)
    occ_j = j_init_occ(JRenderSpec(**rs_kw))
    occ_j = j_set_bitfield(occ_j, jnp.ones_like(occ_j.bitfield))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    img_sj = j_render_stratified(params, JModelSpec(**kw),
                                 JRenderSpec(**rs_kw), occ_j.aabb_infer,
                                 jnp.asarray(o), jnp.asarray(d))["image"]
    img_gj = j_render_rays(params, JModelSpec(**kw), JRenderSpec(**rs_kw),
                           occ_j, jnp.asarray(o), jnp.asarray(d),
                           training=False)["image"]
    np.testing.assert_allclose(img_s.numpy(), np.asarray(img_sj),
                               atol=IMG_TOL)
    np.testing.assert_allclose(np.asarray(img_gj), np.asarray(img_sj),
                               atol=0.05)
