"""pvd_tpu_torch's MLP and plenoxel fields, their ops, parameters and
checkpoints against the JAX package (CPU).

Sizes: the MLP at 4 layers x 32 with PE 4 and skip 1 (and once at the
full 8 x 256, PE 10, skip 3 on a few points); the plenoxel volume at 12^3
(a non-cubic 10 x 12 x 14 too), SH degree 3 (28 channels).  Inputs come
from numpy generators with fixed seeds; float32 heads.

Tolerances:
  * freq_encode: atol 1e-6 (XLA:CPU's sin and cos are not glibc's: a few
    ulps at 2^9 x);
  * grid_sample_3d: 1e-6 x max |out| forward (XLA:CPU contracts the
    weighted sum into FMAs), gradient 1e-6 x max |g| (the scatter adds
    in another order);
  * the fields' outputs: 1e-5 x the output's max (sums through the MLP in
    other orders), their parameter gradients 2e-5 x the leaf's max;
  * parameters and checkpoints: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.engine import checkpoint as j_ckpt
from pvd_tpu.models import api as j_api
from pvd_tpu.models import mlp_field as j_mlp
from pvd_tpu.models import tensors_field as j_tensors
from pvd_tpu.ops.freq import freq_encode as j_freq_encode
from pvd_tpu.ops.freq import freq_output_dim as j_freq_output_dim
from pvd_tpu.ops.grid_sample import grid_sample_3d as j_grid_sample_3d
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.models.api import field_density, field_forward
from pvd_tpu_torch.models.mlp_field import MLPField
from pvd_tpu_torch.models.tensors_field import TensorsField
from pvd_tpu_torch.ops.freq import freq_encode, freq_output_dim
from pvd_tpu_torch.ops.grid_sample import grid_sample_3d
from pvd_tpu_torch.params import (field_from_tree, mlp_field_from_jax,
                                  mlp_tree_from_field, new_field,
                                  occupancy_from_jax, tensors_field_from_jax,
                                  tensors_tree_from_field, tree_from_field)

torch.set_num_threads(1)

FREQ_ATOL = 1e-6
GS_REL = 1e-6
OUT_REL, GRAD_REL = 1e-5, 2e-5

MLP_SMALL = dict(model_type="mlp", nerf_layer_num=4, nerf_layer_wide=32,
                 pe_multires=4, skip=1, compute_dtype="float32")
MLP_FULL = dict(model_type="mlp", compute_dtype="float32")
TENSORS = dict(model_type="tensors", plenoxel_res=(12, 12, 12),
               compute_dtype="float32")
TENSORS_ODD = dict(TENSORS, plenoxel_res=(10, 12, 14))
AABB = np.array([-1.0, -0.8, -1.2, 1.1, 0.9, 1.0], np.float32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


def _jax_tree(kw, seed=0, bg=False):
    spec = JModelSpec(**kw, bg_radius=4.0 if bg else -1.0)
    tree = _np_tree(j_api.init_field(jax.random.PRNGKey(seed), spec))
    if kw["model_type"] == "tensors":
        # logits and SH coefficients of order 1, sigma logits beyond the
        # clip range [-2, 7] on both sides
        rng = np.random.default_rng(seed)
        vol = rng.normal(size=tree["volume"].shape).astype(np.float32)
        vol[..., 0] *= 6.0
        tree["volume"] = vol
    return spec, tree


def _points(n, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


# ---- ops ------------------------------------------------------------------

@pytest.mark.parametrize("n_freqs,include_input", [(4, True), (10, True),
                                                   (6, False)])
def test_freq_encode_matches_jax(n_freqs, include_input):
    x = np.random.default_rng(n_freqs).uniform(
        -1.0, 1.0, size=(3000, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: j_freq_encode(
        v, n_freqs, include_input))(x))
    got = freq_encode(torch.from_numpy(x), n_freqs, include_input).numpy()
    assert got.shape == want.shape == (
        3000, freq_output_dim(3, n_freqs, include_input))
    assert freq_output_dim(3, n_freqs, include_input) == \
        j_freq_output_dim(3, n_freqs, include_input)
    np.testing.assert_allclose(got, want, rtol=0, atol=FREQ_ATOL)


@pytest.mark.parametrize("shape,span", [((12, 12, 12, 28), 1.0),
                                        ((10, 12, 14, 5), 1.3),
                                        ((2, 3, 4, 1), 1.1)],
                         ids=["cube", "odd-outside", "tiny-outside"])
def test_grid_sample_3d_matches_jax(shape, span):
    """Forward and gradient, points past [-1, 1] (span > 1) included: a
    corner outside the volume adds nothing, to the value or the
    gradient."""
    rng = np.random.default_rng(len(shape) + shape[0])
    vol = rng.normal(size=shape).astype(np.float32)
    c = rng.uniform(-span, span, size=(4000, 3)).astype(np.float32)
    c[:8] = [[-1, -1, -1], [1, 1, 1], [1, -1, 1], [0, 0, 0],
             [-1.5, 0, 0], [0, 2, 0], [1, 1, 1.0001], [-1.0001, 0.5, 0.5]]
    g = rng.normal(size=(4000, shape[-1])).astype(np.float32)
    want = np.asarray(jax.jit(j_grid_sample_3d)(vol, c))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(j_grid_sample_3d(v, c) * g)))(vol))
    vt = torch.from_numpy(vol).requires_grad_()
    got = grid_sample_3d(vt, torch.from_numpy(c))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=GS_REL * np.abs(want).max())
    np.testing.assert_allclose(vt.grad.numpy(), want_g, rtol=0,
                               atol=GS_REL * np.abs(want_g).max())
    # fully outside: zero value and no gradient
    assert not want[5].any() and not got[5].detach().any()
    if span > 1:
        assert (np.abs(c) > 1).any(axis=-1).mean() > 0.1


def test_grid_sample_3d_matches_torch_grid_sample():
    """The same function as F.grid_sample(align_corners=True, zeros) on the
    [1, C, D, H, W] view of the volume."""
    rng = np.random.default_rng(3)
    vol = torch.from_numpy(rng.normal(size=(6, 7, 8, 4)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(500, 3))
                         .astype(np.float32))
    ref = torch.nn.functional.grid_sample(
        vol.permute(3, 0, 1, 2)[None], c[None, :, None, None, :],
        align_corners=True, padding_mode="zeros")[0, :, :, 0, 0].T
    np.testing.assert_allclose(grid_sample_3d(vol, c).numpy(), ref.numpy(),
                               rtol=0, atol=1e-5)


# ---- fields ---------------------------------------------------------------

def _jax_outputs(spec, tree, x, d, cot):
    """JAX forward outputs, density and the parameter VJP of sum(out *
    cotangents)."""
    impl = {"mlp": j_mlp, "tensors": j_tensors}[spec.model_type]
    aabb = jnp.asarray(AABB)

    def fwd(p):
        o = impl.forward(p, spec, x, d, aabb, True)
        parts = [o.sigma, o.rgb, o.sigma_logit]
        if o.fea_sc is not None:
            parts.append(o.fea_sc)
        return parts

    outs, vjp = jax.vjp(fwd, jax.tree_util.tree_map(jnp.asarray, tree))
    (grads,) = vjp([jnp.asarray(c[:o.size].reshape(o.shape))
                    for c, o in zip(cot, outs)])
    return outs, impl.density(tree, spec, x, aabb), grads


@pytest.mark.parametrize("kw,n", [(MLP_SMALL, 2000), (MLP_FULL, 256),
                                  (TENSORS, 3000), (TENSORS_ODD, 3000)],
                         ids=["mlp-small", "mlp-full", "tensors",
                              "tensors-odd"])
def test_field_matches_jax(kw, n):
    """forward (sigma, rgb, clipped logit, fea_sc), density and every
    parameter gradient; the plenoxel density is the UNCLIPPED logit's."""
    spec_j, tree = _jax_tree(kw, seed=n)
    x, d = _points(n, n + 1, -1.1, 1.1)
    rng = np.random.default_rng(n + 2)
    cot = [rng.normal(size=n * k).astype(np.float32) for k in (1, 3, 1, 16)]
    outs, dens, want_g = _np_tree(jax.jit(
        lambda t: _jax_outputs(spec_j, t, x, d, cot))(tree))
    spec = ModelSpec(**kw)
    field = field_from_tree(tree, spec, "cpu")
    aabb = torch.from_numpy(AABB)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    o = field_forward(field, spec, xt, dt, aabb)
    parts = [o.sigma, o.rgb, o.sigma_logit] + (
        [] if o.fea_sc is None else [o.fea_sc])
    assert len(parts) == len(outs)
    assert (o.fea_sc is None) == (kw["model_type"] == "tensors")
    loss = 0.0
    for p, w, c in zip(parts, outs, cot):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=OUT_REL * np.abs(w).max())
        loss = loss + (p * torch.from_numpy(c[:p.numel()]).reshape(
            p.shape)).sum()
    loss.backward()
    got_d = field_density(field, spec, xt, aabb).detach().numpy()
    np.testing.assert_allclose(got_d, dens, rtol=0,
                               atol=OUT_REL * np.abs(dens).max())
    got_g = tree_from_field(field, grad=True)
    for (path, w), g in zip(_leaves(want_g), jax.tree_util.tree_leaves(
            got_g)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    if kw["model_type"] == "tensors":
        # the density path does not clip: logits beyond 7 give exp > e^7
        assert dens.max() > np.exp(7.0) * 1.01
        assert float(o.sigma.max()) <= np.exp(7.0) * (1 + 1e-6)


def test_mlp_field_layers_match_jax():
    """The layer widths (the skip layer takes the encoded input too) and
    the output width that feeds the shared heads."""
    for kw in (MLP_SMALL, MLP_FULL, dict(MLP_SMALL, skip=0),
               dict(MLP_SMALL, nerf_layer_num=6, skip=3)):
        _, tree = _jax_tree(kw)
        field = MLPField(ModelSpec(**kw), "cpu")
        assert [tuple(lin.weight.shape[::-1]) for lin in field.nerf_mlp] == \
            [p["w"].shape for p in tree["nerf_mlp"]]
        assert field.nerf_mlp[-1].out_features == 28


def test_mlp_field_bf16_close_to_jax():
    """bf16 layers (the default compute dtype): the same casts as the JAX
    package, so the outputs agree to bf16 rounding (atol 2e-2 x max)."""
    kw = dict(MLP_SMALL, compute_dtype="bfloat16")
    spec_j, tree = _jax_tree(kw, seed=4)
    x, d = _points(512, 5)
    o_j = j_mlp.forward(jax.tree_util.tree_map(jnp.asarray, tree), spec_j,
                        x, d, jnp.asarray(AABB), True)
    field = mlp_field_from_jax(tree, ModelSpec(**kw), "cpu")
    with torch.no_grad():
        o = field(torch.from_numpy(x), torch.from_numpy(d))
    for a, b in ((o.rgb, o_j.rgb), (o.fea_sc, o_j.fea_sc)):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-2 * np.abs(b).max())


@pytest.mark.parametrize("kw,n", [(MLP_SMALL, 2000), (MLP_FULL, 512)],
                         ids=["mlp-small", "mlp-full"])
def test_mlp_field_bf16_grads_close_to_jax(kw, n):
    """Every parameter gradient of the bf16 MLP field (the default compute
    dtype, the teacher's) against JAX's jitted VJP: the same direction
    (cosine >= 0.999 per leaf) and within 5e-2 of the leaf's max.  The
    bf16 products round in other orders; seen: cosine >= 0.99985 and
    2.3e-2 of the max at the full width."""
    kw = dict(kw, compute_dtype="bfloat16")
    spec_j, tree = _jax_tree(kw, seed=n)
    x, d = _points(n, n + 1, -1.1, 1.1)
    rng = np.random.default_rng(n + 2)
    cot = [rng.normal(size=n * k).astype(np.float32) for k in (1, 3, 1, 16)]
    _, _, want_g = _np_tree(jax.jit(
        lambda t: _jax_outputs(spec_j, t, x, d, cot))(tree))
    spec = ModelSpec(**kw)
    field = field_from_tree(tree, spec, "cpu")
    o = field_forward(field, spec, torch.from_numpy(x), torch.from_numpy(d),
                      torch.from_numpy(AABB))
    loss = sum((p * torch.from_numpy(c[:p.numel()]).reshape(p.shape)).sum()
               for p, c in zip((o.sigma, o.rgb, o.sigma_logit, o.fea_sc),
                               cot))
    loss.backward()
    for (path, w), g in zip(_leaves(want_g), jax.tree_util.tree_leaves(
            tree_from_field(field, grad=True))):
        w = np.asarray(w, np.float64).ravel()
        g = np.asarray(g, np.float64).ravel()
        cos = w @ g / (np.linalg.norm(w) * np.linalg.norm(g))
        assert cos >= 0.999, (jax.tree_util.keystr(path), cos)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=5e-2 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_gradient_matches_jax(dtype):
    """`ops.activation.clip` against jnp.clip: the same values, and the
    same gradient, half of it for a value exactly on a bound (exact)."""
    from pvd_tpu_torch.ops.activation import clip

    x = np.array([-3.0, -2.0, -1.9921875, 0.5, 7.0, 7.25, -2.0, 7.0],
                 np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want, vjp = jax.vjp(lambda v: jnp.clip(v, -2.0, 7.0), jx)
    (want_g,) = vjp(jnp.asarray(g, dtype))
    t = torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True)
    got = clip(t, -2.0, 7.0)
    got.backward(torch.tensor(g, dtype=t.dtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(want_g, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heads_logit_on_the_clip_bound_matches_jax(dtype):
    """The shared heads with a sigma logit exactly on -2 and on 7 (the
    sigma_net here gives logit = -enc[:, 0]): the gradient of the logit
    and sigma with respect to the encoding and the sigma_net, against
    JAX's (exact at float32; 1e-2 of the max at bfloat16, whose products
    round in other orders).  On a bound the clip passes half the
    gradient, as jnp.clip does."""
    from pvd_tpu.models import heads as j_heads
    from pvd_tpu_torch.models.heads import shared_sigma_color

    kw = dict(MLP_SMALL, compute_dtype=dtype)
    spec_j, tree = _jax_tree(kw, seed=7)
    w0 = np.zeros_like(tree["sigma_net"][0]["w"])
    w1 = np.zeros_like(tree["sigma_net"][1]["w"])
    w0[0, 0], w0[0, 1], w1[0, 0], w1[1, 0] = 1.0, -1.0, -1.0, 1.0
    w1[2:, 1:] = np.random.default_rng(1).normal(
        scale=0.1, size=w1[2:, 1:].shape)
    w0[1:, 2:] = np.random.default_rng(2).normal(
        scale=0.1, size=w0[1:, 2:].shape)
    tree["sigma_net"] = [{"w": w0}, {"w": w1}]
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(8, w0.shape[0])).astype(np.float32)
    enc[:, 0] = [2.0, -7.0, 2.0, -7.0, 0.5, 3.0, -8.0, 1.0]
    d = rng.normal(size=(8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cot = rng.normal(size=(2, 8)).astype(np.float32)

    def j_loss(p, e):
        o = j_heads.shared_sigma_color(p, spec_j, e, jnp.asarray(d), True)
        return jnp.sum(o.sigma_logit * cot[0]) + jnp.sum(o.sigma * cot[1])

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want_p, want_e = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(enc))
    field = field_from_tree(tree, ModelSpec(**kw), "cpu")
    e = torch.tensor(enc, requires_grad=True)
    o = shared_sigma_color(field, field.spec, e, torch.from_numpy(d), True)
    np.testing.assert_array_equal(o.sigma_logit.detach().numpy()[:4],
                                  [-2.0, 7.0, -2.0, 7.0])
    ((o.sigma_logit * torch.from_numpy(cot[0])).sum()
     + (o.sigma * torch.from_numpy(cot[1])).sum()).backward()
    tol = 0.0 if dtype == "float32" else 1e-2
    pairs = [(e.grad.numpy(), np.asarray(want_e))] + [
        (lin.weight.grad.numpy().T, np.asarray(w["w"]))
        for lin, w in zip(field.sigma_net, want_p["sigma_net"])]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=tol * np.abs(want).max())


def test_edit_erase_region_matches_jax():
    _, tree = _jax_tree(dict(TENSORS, plenoxel_res=(8, 200, 140)), seed=2)
    want = j_tensors.edit_erase_region(
        jax.tree_util.tree_map(jnp.asarray, tree))
    field = tensors_field_from_jax(
        tree, ModelSpec(**dict(TENSORS, plenoxel_res=(8, 200, 140))), "cpu")
    field.edit_erase_region()
    np.testing.assert_array_equal(field.volume.detach().numpy(),
                                  np.asarray(want["volume"]))
    assert (field.volume[:, 160:, :128, 0] == -100.0).all()
    assert (field.volume[:, :160, :, 0] != -100.0).all()


def test_init_matches_jax_statistics():
    """Fresh fields: the JAX package's shapes, the plenoxel volume N(0,
    0.02), the MLP layers U(+-1/sqrt(fan_in)) with biases."""
    gen = torch.Generator().manual_seed(0)
    vol = TensorsField(ModelSpec(**TENSORS), "cpu", gen).volume.detach()
    _, tree = _jax_tree(TENSORS)
    assert vol.shape == tree["volume"].shape == (12, 12, 12, 28)
    assert abs(float(vol.std()) - 0.02) < 1e-3
    field = new_field(ModelSpec(**MLP_SMALL), "cpu", gen)
    for lin in field.nerf_mlp:
        bound = lin.in_features ** -0.5
        assert float(lin.weight.abs().max()) <= bound
        assert float(lin.bias.abs().max()) <= bound
        assert float(lin.bias.abs().max()) > 0.5 * bound


# ---- parameters and checkpoints ------------------------------------------

@pytest.mark.parametrize("kw,bg", [(MLP_SMALL, False), (MLP_SMALL, True),
                                   (TENSORS, False), (TENSORS, True)],
                         ids=["mlp", "mlp-bg", "tensors", "tensors-bg"])
def test_params_round_trip(kw, bg):
    """JAX tree -> field -> JAX tree is exact, the background model (its
    direction encoder at the plenoxel degree for a plenoxel field)
    included; a tree of the wrong shape is refused."""
    spec_j, tree = _jax_tree(kw, bg=bg)
    spec = ModelSpec(**kw, bg_radius=spec_j.bg_radius)
    field = field_from_tree(tree, spec, "cpu")
    back = (mlp_tree_from_field if kw["model_type"] == "mlp"
            else tensors_tree_from_field)(field)
    _assert_trees_equal(back, tree)
    assert ("bg" in back) == bg
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    if kw["model_type"] == "mlp":
        bad["nerf_mlp"][0]["b"] = bad["nerf_mlp"][0]["b"][:-1]
    else:
        bad["volume"] = bad["volume"][:-1]
    with pytest.raises(ValueError):
        field_from_tree(bad, spec, "cpu")


@pytest.fixture(scope="module")
def occ_pair():
    rs = JPVDConfig(grid_size=16).render_spec()
    rng = np.random.default_rng(9)
    occ = j_set_bitfield(j_init_occ(rs),
                         jnp.asarray(rng.uniform(size=16 ** 3) < 0.1))
    return occ, occupancy_from_jax(occ, "cpu")


@pytest.mark.parametrize("kw", [MLP_SMALL, TENSORS], ids=["mlp", "tensors"])
def test_checkpoints_cross_load(kw, occ_pair, tmp_path):
    """A JAX-written checkpoint of each tree loads into the port's field;
    a port-written one loads in the JAX package with identical arrays; the
    port reads its own back."""
    occ_j, occ = occ_pair
    name = kw["model_type"]
    spec_j, tree = _jax_tree(kw, seed=3)
    cfg_j = JPVDConfig(model_type=name, plenoxel_res=(12, 12, 12),
                       nerf_layer_num=4, nerf_layer_wide=32, PE=4, skip=1)
    path = j_ckpt.save_checkpoint(str(tmp_path / "j"), name, 7, tree, occ_j,
                                  config_json=cfg_j.to_json())
    got = ckpt.load_checkpoint(path, "cpu")
    cfg = PVDConfig.from_json(got["config_json"])
    field = field_from_tree(got["params"], cfg.model_spec(), "cpu")
    _assert_trees_equal(tree_from_field(field), tree)
    p2 = ckpt.save_checkpoint(str(tmp_path / "t"), name, 8,
                              tree_from_field(field), occ,
                              config_json=cfg.to_json())
    back = j_ckpt.load_checkpoint(p2)
    assert back["step"] == 8
    _assert_trees_equal(back["params"], tree)
    assert JPVDConfig.from_json(back["config_json"]).model_spec() == \
        cfg_j.model_spec()
    _assert_trees_equal(ckpt.load_checkpoint(p2, "cpu")["params"], tree)


@pytest.mark.parametrize("tea,stu", [("mlp", "hash"), ("hash", "mlp"),
                                     ("mlp", "tensors"), ("tensors", "mlp"),
                                     ("tensors", "vm"), ("mlp", "mlp")])
def test_warm_start_student_matches_jax(tea, stu):
    """Every student leaf whose path and shape match a teacher leaf takes
    the teacher's value: the shared heads between hash and MLP fields,
    nothing for a plenoxel side."""
    kws = {"mlp": MLP_SMALL, "tensors": TENSORS,
           "hash": dict(model_type="hash", hash_log2_size=10),
           "vm": dict(model_type="vm", vm_resolution=(6, 7, 8))}
    _, t = _jax_tree(kws[tea], seed=1)
    _, s = _jax_tree(kws[stu], seed=2)
    want = _np_tree(j_ckpt.warm_start_student(
        jax.tree_util.tree_map(jnp.asarray, s),
        jax.tree_util.tree_map(jnp.asarray, t)))
    got = ckpt.warm_start_student(s, t)
    _assert_trees_equal(got, want)
    if {tea, stu} == {"mlp", "hash"}:
        np.testing.assert_array_equal(got["sigma_net"][0]["w"],
                                      t["sigma_net"][0]["w"])
