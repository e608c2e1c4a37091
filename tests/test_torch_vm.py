"""pvd_tpu_torch's VM field against the JAX package (CPU): forward,
density, the L1 regularizer, parameter gradients and the plain plane x line
sample and its backward (on K5's hard inputs, `chip_smoke.k5_hard_inputs`,
which the card holds K5 to), at non-cubic resolutions so that a swapped
axis fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.models import vm_field as j_vm
from pvd_tpu_torch.config import ModelSpec
from pvd_tpu_torch.ops.vm_sample import (grad_buffers, k4_variant,
                                         k5_variant, vm_sample_bwd_plain,
                                         vm_sample_plain)
from pvd_tpu_torch.params import vm_field_from_jax, vm_tree_from_field
from chip_smoke import k5_hard_inputs

torch.set_num_threads(1)

# forward: the same f32 ops, summed in other orders
FWD_TOL = 1e-5
# gradients: scatter-adds of the same terms in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# K5's reference: the plain backward's scatter-adds and JAX's VJP (the
# custom _plane_sample4_bwd scatter and the one-hot matmul's transpose)
# sum the same f32 products in other orders; 1e-6 of each leaf's max |g|,
# and 1e-5 where every sample lands on the same rows ("one_cell": 4101
# random-sign terms a row, whose sums in two orders drift apart by ~sqrt(n)
# roundings of 2^-24, ~4e-6 of the sum)
K5_GRAD_REL, K5_ONE_CELL_REL = 1e-6, 1e-5

RES = (20, 24, 28)
SPEC_KW = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
               vm_resolution=RES, compute_dtype="float32")
AABB = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def params():
    tree = j_vm.init(jax.random.PRNGKey(4), JModelSpec(**SPEC_KW))
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[:8] = [[-1, -1, -1], [1, 1, 1], [-1, 1, -1], [1, -1, 1],
             [1, 1, -1], [-1, -1, 1], [0, 0, 0], [1, 0, -1]]
    # just outside the box: the plane's tent weights vanish there, the
    # line extrapolates
    x[8:10] = [[1.05, -1.07, 1.1], [-1.1, 1.06, -1.04]]
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


def _field(params):
    return vm_field_from_jax(params, ModelSpec(**SPEC_KW), "cpu")


def test_layout_round_trips(params):
    field = _field(params)
    assert [tuple(p.shape) for p in field.planes] == [(24, 20, 16),
                                                      (28, 20, 16),
                                                      (28, 24, 16)]
    assert [tuple(v.shape) for v in field.lines] == [(28, 16), (24, 16),
                                                     (20, 16)]
    back = vm_tree_from_field(field)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("want_color", [True, False])
def test_forward_matches_jax(params, want_color):
    x, d = _points()
    want = j_vm.forward(jax.tree_util.tree_map(jnp.asarray, params),
                        JModelSpec(**SPEC_KW), jnp.asarray(x), jnp.asarray(d),
                        jnp.asarray(AABB), want_color)
    with torch.no_grad():
        got = _field(params)(torch.from_numpy(x), torch.from_numpy(d),
                             torch.from_numpy(AABB), want_color)
    for name in ("sigma", "sigma_logit", "fea_sc", "rgb"):
        g, w = getattr(got, name), getattr(want, name)
        if not want_color and name == "rgb":
            assert g is None and w is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=name)
    # the features have structure, and the clip bites nowhere
    fea = got.fea_sc.numpy()
    assert fea.std() > 1e-3 and (np.abs(fea) < 2.0).all()


def test_density_and_l1_match_jax(params):
    x, _ = _points(seed=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = j_vm.density(jp, JModelSpec(**SPEC_KW), jnp.asarray(x),
                        jnp.asarray(AABB))
    field = _field(params)
    with torch.no_grad():
        got = field.density(torch.from_numpy(x), torch.from_numpy(AABB))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(field.density_l1().item(),
                               float(j_vm.density_l1(jp)), rtol=1e-6)


def test_gradients_match_jax(params):
    """A fixed random linear functional of fea_sc and rgb, plus the L1
    term, differentiated into every parameter leaf."""
    x, d = _points(seed=2)
    rng = np.random.default_rng(7)
    a = rng.normal(size=(x.shape[0], 16)).astype(np.float32)
    b = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    spec_j = JModelSpec(**SPEC_KW)

    def j_loss(p):
        out = j_vm.forward(p, spec_j, jnp.asarray(x), jnp.asarray(d),
                           jnp.asarray(AABB), True)
        return (jnp.sum(out.fea_sc * a) + jnp.sum(out.rgb * b)
                + 0.5 * j_vm.density_l1(p))

    want = jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    field = _field(params)
    out = field(torch.from_numpy(x), torch.from_numpy(d),
                torch.from_numpy(AABB), True)
    loss = (out.fea_sc * torch.from_numpy(a)).sum() \
        + (out.rgb * torch.from_numpy(b)).sum() + 0.5 * field.density_l1()
    loss.backward()
    got = vm_tree_from_field(field, grad=True)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g) == 16
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_plain_sample_matches_jax(params):
    """vm_sample_plain alone against _plane_packed_mxu * _line_mxu, on
    points that sit on both ends of each axis (p = 0 and p = L - 1)."""
    x, _ = _points(seed=3)
    field = _field(params)
    prod = vm_sample_plain(list(field.planes), list(field.lines),
                           torch.from_numpy(x)).detach().numpy()
    assert prod.shape == (3, x.shape[0], 16)
    xn = jnp.asarray(x)
    for i in range(3):
        m0, m1 = j_vm.MAT_IDS[i]
        v = j_vm.VEC_IDS[i]
        mat = jnp.concatenate([params["sigma_mat"][i],
                               params["color_mat"][i]], -1)
        vec = jnp.concatenate([params["sigma_vec"][i],
                               params["color_vec"][i]], -1)
        H, W, _ = mat.shape
        px = (xn[:, m0] + 1.0) * 0.5 * (W - 1)
        py = (xn[:, m1] + 1.0) * 0.5 * (H - 1)
        pz = (xn[:, v] + 1.0) * 0.5 * (vec.shape[0] - 1)
        want = j_vm._plane_packed_mxu(mat, px, py) * j_vm._line_mxu(vec, pz)
        np.testing.assert_allclose(prod[i], np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"branch {i}")


def _jax_sample(planes, lines, x):
    """JAX's plane x line sample ([3, M, R]) of numpy planes [H, W, R] and
    lines [L, R]."""
    xn = jnp.asarray(x)
    out = []
    for i in range(3):
        m0, m1 = j_vm.MAT_IDS[i]
        mat, vec = jnp.asarray(planes[i]), jnp.asarray(lines[i])
        H, W, _ = mat.shape
        px = (xn[:, m0] + 1.0) * 0.5 * (W - 1)
        py = (xn[:, m1] + 1.0) * 0.5 * (H - 1)
        pz = (xn[:, j_vm.VEC_IDS[i]] + 1.0) * 0.5 * (vec.shape[0] - 1)
        out.append(j_vm._plane_packed_mxu(mat, px, py)
                   * j_vm._line_mxu(vec, pz))
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("rank", [5, 16])
def test_plain_sample_matches_jax_on_k4_cases(rank):
    """The plain sample (K4's reference on the card) against JAX on the
    inputs chip_smoke.py holds K4 to beyond the path's: a rank that is
    not a multiple of 4 (K4's scalar instantiation) and one that is, a
    ragged sample count, and positions outside [-1, 1] on every axis,
    where the tent weights vanish and the lines extrapolate."""
    rng = np.random.default_rng(rank)
    planes = [(0.1 * rng.standard_normal((RES[m1], RES[m0], rank)))
              .astype(np.float32) for m0, m1 in j_vm.MAT_IDS]
    lines = [(0.1 * rng.standard_normal((RES[v], rank))).astype(np.float32)
             for v in j_vm.VEC_IDS]
    x = rng.uniform(-1.3, 1.3, (301, 3)).astype(np.float32)
    x[:6] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [-1.3, 0.2, 1.3],
             [1.3, -1.3, 0.0], [0.0, 1.2, -1.2], [-1.0 - 2 ** -20, 1.0, 0.5]]
    for d in range(3):  # every axis has points beyond both ends
        assert (x[:, d] < -1).any() and (x[:, d] > 1).any()
    got = vm_sample_plain([torch.from_numpy(p) for p in planes],
                          [torch.from_numpy(v) for v in lines],
                          torch.from_numpy(x)).numpy()
    assert got.shape == (3, 301, rank)
    np.testing.assert_allclose(got, _jax_sample(planes, lines, x),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_k4_variant_picks_by_rank_and_alignment():
    """K4's float4 lanes need R % 4 == 0 and 16-byte aligned tables; the
    lanes per sample are R / 8 (float4, two quads a lane) or R, to a power
    of two, <= 32."""
    aligned = [0, 16, 4096]
    assert k4_variant(64, aligned) == ("float4", 8)
    assert k4_variant(16, aligned) == ("float4", 2)
    assert k4_variant(48, aligned) == ("float4", 8)
    assert k4_variant(4, aligned) == ("float4", 1)
    assert k4_variant(200, aligned) == ("float4", 32)
    assert k4_variant(64, aligned + [4]) == ("scalar", 32)
    assert k4_variant(5, aligned) == ("scalar", 8)
    assert k4_variant(3, aligned) == ("scalar", 4)
    assert k4_variant(1, aligned) == ("scalar", 1)



def test_k5_variant_picks_by_rank_and_alignment():
    """K5's float4 lanes need R % 4 == 0 and 16-byte aligned tables,
    gradients and g; the lanes per sample are R / 4 (float4, one quad a
    lane) or R, to a power of two, <= 32."""
    aligned = [0, 16, 4096]
    assert k5_variant(64, aligned) == ("float4", 16)
    assert k5_variant(16, aligned) == ("float4", 4)
    assert k5_variant(48, aligned) == ("float4", 16)
    assert k5_variant(4, aligned) == ("float4", 1)
    assert k5_variant(200, aligned) == ("float4", 32)
    assert k5_variant(64, aligned + [4]) == ("scalar", 32)
    assert k5_variant(5, aligned) == ("scalar", 8)
    assert k5_variant(1, aligned) == ("scalar", 1)


def test_grad_buffers_are_zeroed_aligned_views_of_one_buffer():
    """K5's six gradients: zero, shaped as the tables, disjoint views of
    one buffer, each starting on a 16-byte boundary (K5's float4 atomics),
    at ranks whose tables are not whole quads."""
    for rank in (5, 16):
        planes = [torch.ones(h, w, rank) for h, w in ((3, 5), (7, 2), (4, 4))]
        lines = [torch.ones(n, rank) for n in (3, 9, 2)]
        g_planes, g_lines = grad_buffers(planes, lines)
        views = g_planes + g_lines
        base = views[0].untyped_storage().data_ptr()
        ends = []
        for v, t in zip(views, planes + lines):
            assert v.shape == t.shape and v.is_contiguous()
            assert not v.any() and v.untyped_storage().data_ptr() == base
            assert v.storage_offset() % 4 == 0
            ends.append((v.storage_offset(), v.storage_offset() + v.numel()))
        for (_, end), (start, _) in zip(ends, ends[1:]):
            assert end <= start

K5_CASES = k5_hard_inputs()


def _cells(x, res):
    """Per branch, the plane cells and line rows of positions x (numpy, the
    plain version's floor / clip)."""
    out = []
    for i in range(3):
        m0, m1 = j_vm.MAT_IDS[i]
        v = j_vm.VEC_IDS[i]
        bx, by, bz = (np.clip(np.floor((x[:, a] + 1.0) * 0.5 * (res[a] - 1)),
                              0, res[a] - 2) for a in (m0, m1, v))
        out.append((by * res[m0] + bx, bz))
    return out


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_plain_backward_matches_jax_vjp_on_k5_hard_inputs(name):
    """vm_sample_bwd_plain (K5's reference on the card) against jax.vjp of
    _plane_packed_mxu * _line_mxu per branch, on K5's hard inputs: every
    sample in one plane cell and line row, every third upstream row zero,
    positions beyond [-1, 1] on every axis, rank 5 (and 16 and 64
    elsewhere), a 640-row line; 4101 samples, non-cubic resolutions."""
    planes, lines, x, g = K5_CASES[name]
    res = (planes[0].shape[1], planes[0].shape[0], lines[0].shape[0])
    if name == "one_cell":
        for cell, row in _cells(x, res):
            assert len(np.unique(cell)) == 1 and len(np.unique(row)) == 1
    if name == "outside":
        for a in range(3):
            assert (x[:, a] < -1).any() and (x[:, a] > 1).any()
    if name == "zero_rows":
        assert not g[:, ::3].any() and np.abs(g[:, 1::3]).min(1).all()
    got_p, got_l = vm_sample_bwd_plain(
        [torch.from_numpy(a) for a in planes],
        [torch.from_numpy(a) for a in lines], torch.from_numpy(x),
        torch.from_numpy(g))
    xn = jnp.asarray(x)
    for i in range(3):
        m0, m1 = j_vm.MAT_IDS[i]
        v = j_vm.VEC_IDS[i]

        def sample(mat, vec):
            H, W, _ = mat.shape
            px = (xn[:, m0] + 1.0) * 0.5 * (W - 1)
            py = (xn[:, m1] + 1.0) * 0.5 * (H - 1)
            pz = (xn[:, v] + 1.0) * 0.5 * (vec.shape[0] - 1)
            return j_vm._plane_packed_mxu(mat, px, py) * j_vm._line_mxu(vec,
                                                                        pz)

        _, vjp = jax.vjp(sample, jnp.asarray(planes[i]),
                         jnp.asarray(lines[i]))
        want_p, want_l = (np.asarray(w) for w in vjp(jnp.asarray(g[i])))
        for got, want, leaf in ((got_p[i], want_p, "plane"),
                                (got_l[i], want_l, "line")):
            scale = np.abs(want).max()
            assert scale > 0, (name, i, leaf)
            err = np.abs(got.numpy() - want).max() / scale
            tol = K5_ONE_CELL_REL if name == "one_cell" else K5_GRAD_REL
            assert err <= tol, (name, i, leaf, err)
