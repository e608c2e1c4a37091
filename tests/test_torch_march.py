"""pvd_tpu_torch march, compaction and render against the JAX package (CPU).

The plain march must give the JAX package's t, dt and mask exactly and
delta_depth within 1e-6 (the same f32 ops in the same order), in eval and
train mode, with and without a perturbation, at one and two cascades, on
the plain lattice (dt_gamma 0) and on the geometric one (dt_gamma 1/256,
whose serial recurrence t += clip(t * dt_gamma, dt_min, dt_max) the port
runs in the same f32 ops).  The geometric march also matches the
reference-DDA oracles of tests/test_renderer.py (t within 1e-5, the sample
counts exactly), and `render_rays` with a background model matches JAX's
on the padded and the compacted paths.  K14's hard lattices
(`chip_smoke.k14_hard_inputs`, which the card holds K14 to) go through
both packages' plain marches too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.ops.aabb import near_far_from_aabb as j_near_far
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu.render.renderer import compact_samples as j_compact
from pvd_tpu.render.renderer import march_rays as j_march
from pvd_tpu.render.renderer import render_rays as j_render_rays
from pvd_tpu_torch.config import ModelSpec, RenderSpec
from pvd_tpu_torch.params import hash_field_from_jax, occupancy_from_jax
from pvd_tpu_torch.render.renderer import (compact_samples, dt_max_of,
                                           dt_min_of, march_rays,
                                           render_rays)
from chip_smoke import k14_hard_inputs
from test_renderer import oracle_march_dda_gamma, oracle_march_dda_mip
from test_torch_background import bg_grad_atol

torch.set_num_threads(1)

DD_TOL = 1e-6  # delta_depth: u - prev, same ops; allowance for ulp drift
ORACLE_TOL = 1e-5  # the oracles' numpy positions round without the FMA
# render: the same samples, f32 heads and the background MLP summed in
# other orders; the background's gradients 2e-5 of their max |g|, widened
# for 1-ulp polar differences (bg_grad_atol)
IMG_TOL, BG_GRAD_REL_ATOL = 1e-5, 2e-5
H, STEPS, S_TRAIN = 32, 128, 32
GAMMA = 1 / 256


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


def _case(bound, s_max, seed, dt_gamma=0.0):
    rspec_j = JRenderSpec(bound=bound, grid_size=H, max_steps=STEPS,
                          max_samples=s_max, dt_gamma=dt_gamma)
    rspec_t = RenderSpec(bound=bound, grid_size=H, max_steps=STEPS,
                         max_samples=s_max, dt_gamma=dt_gamma)
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


@pytest.mark.parametrize("dt_gamma", [0.0, GAMMA], ids=["plain", "geom"])
@pytest.mark.parametrize("bound", [1.0, 2.0])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("perturb", [False, True])
def test_march_plain_matches_jax(bound, mode, perturb, dt_gamma):
    """JAX's plain lattice (no probe masks): `_t_lattice`, or with dt_gamma
    the scan of `_t_lattice_ln`, then `_occupancy_lookup` with each
    point's own dt."""
    s_max = STEPS if mode == "eval" else S_TRAIN
    rspec_j, rspec_t, bitfield, o, d, nears, fars = _case(bound, s_max, 3,
                                                          dt_gamma)
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


@pytest.mark.parametrize("bound", [1.0, 2.0])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_march_geometric_matches_reference_dda(bound, mode):
    """The geometric march against the reference DDA's transcriptions:
    `oracle_march_dda_gamma` (one cascade) and `oracle_march_dda_mip` (the
    cascade pick of raymarching.cu:44-56), per ray the same sample count
    and t, dt within 1e-5."""
    s_max = STEPS if mode == "eval" else S_TRAIN
    rspec_j, rspec_t, bitfield, o, d, nears, fars = _case(bound, s_max, 7,
                                                          GAMMA)
    st = _torch_march(rspec_t, bitfield, o, d, nears, fars)
    C = rspec_t.cascades
    t, dt, mask = st.t.numpy(), st.dt.numpy(), st.mask.numpy()
    checked = 0
    for i in range(len(o)):
        if C == 1:
            t_ref, dt_ref = oracle_march_dda_gamma(
                o[i], d[i], float(nears[i]), float(fars[i]),
                bitfield.reshape(H, H, H), H, bound, STEPS, GAMMA, s_max)
        else:
            t_ref, dt_ref = oracle_march_dda_mip(
                o[i], d[i], float(nears[i]), float(fars[i]), bitfield, H, C,
                bound, STEPS, GAMMA, s_max)
        got_t, got_dt = t[i][mask[i]], dt[i][mask[i]]
        assert len(got_t) == len(t_ref), (i, len(got_t), len(t_ref))
        if len(t_ref):
            np.testing.assert_allclose(got_t, t_ref, rtol=0, atol=ORACLE_TOL)
            np.testing.assert_allclose(got_dt, dt_ref, rtol=0,
                                       atol=ORACLE_TOL)
            checked += 1
    assert checked >= 24


K14_CASES = k14_hard_inputs()


@pytest.mark.parametrize("name", sorted(K14_CASES))
def test_march_plain_matches_jax_on_k14_hard_inputs(name):
    """The plain march against JAX's plain-lattice march_rays on K14's hard
    lattices: dt_gamma 1/16 with rays that start inside the box, so one
    ray crosses the dt_min clamp, the geometric steps and the dt_max clamp
    (each regime is asserted where the case is made for it); L = 100 (not
    a multiple of 32) with S = 1, 2 and 128 > L; one cascade; 45 rays (not
    a multiple of a block's 8).  t, dt, mask, t0 exact, delta_depth within
    DD_TOL.  A perturbed case draws u from a JAX key, as JAX's march
    does."""
    spec, min_near, bitfield, o, d, u = K14_CASES[name]
    rspec_j, rspec_t = JRenderSpec(**spec), RenderSpec(**spec)
    bound = spec["bound"]
    aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
    nears, fars = (np.asarray(a) for a in j_near_far(o, d, aabb, min_near))
    key = None if u is None else jax.random.PRNGKey(17)
    u = None if key is None else np.asarray(
        jax.random.uniform(key, (o.shape[0],)))
    sj = jax.jit(lambda *a: j_march(*a, rspec_j, key))(
        jnp.asarray(bitfield), o, d, nears, fars)
    st = _torch_march(rspec_t, bitfield, o, d, nears, fars, u)
    _assert_same(sj, st)
    assert st.mask.sum() >= min(rspec_t.max_samples, 8) * 8
    if name.startswith("three_regimes") or name == "one_cascade":
        dts = st.dt.numpy()[st.mask.numpy()]
        lo, hi = dt_min_of(rspec_t), dt_max_of(rspec_t)
        assert (dts == np.float32(lo)).any() and (dts == np.float32(hi)).any()
        assert ((dts > lo) & (dts < hi)).any()
    if spec["max_samples"] < spec["max_steps"]:  # train: prefixes
        m = st.mask.numpy()
        assert (m[:, :-1] | ~m[:, 1:]).all()


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


BG_SPEC = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
               compute_dtype="float32", bound=2.0, bg_radius=32.0)


@pytest.fixture(scope="module")
def bg_field():
    """A small hash field with a background model, O(1) tables (the
    reference's 1e-4 init would make the background a constant 0.5)."""
    tree = jax.tree_util.tree_map(np.asarray, j_init_field(
        jax.random.PRNGKey(4), JModelSpec(**BG_SPEC)))
    rng = np.random.default_rng(4)
    tree["encoder"] = rng.uniform(-1, 1, tree["encoder"].shape) \
        .astype(np.float32)
    tree["bg"]["encoder"] = rng.uniform(-1, 1, tree["bg"]["encoder"].shape) \
        .astype(np.float32)
    return tree


@pytest.mark.parametrize("spr", [0.0, 8.0], ids=["padded", "compacted"])
def test_render_rays_with_background_matches_jax(bg_field, spr):
    """Two cascades, the geometric lattice and the background model, in
    training (perturbed, per-ray bg_color that the background replaces):
    image, depth and weights_sum, and the gradients of the image's MSE
    against a random target into the background's table and MLP (the
    field's own leaves: tests/test_torch_large_scene.py's whole steps)."""
    rspec_j, rspec_t, bitfield, o, d, nears, fars = _case(2.0, S_TRAIN, 9,
                                                          GAMMA)
    rspec_j = dataclasses.replace(rspec_j, samples_per_ray=spr,
                                  coarse_march=False)
    rspec_t = dataclasses.replace(rspec_t, samples_per_ray=spr)
    spec_j, spec_t = JModelSpec(**BG_SPEC), ModelSpec(**BG_SPEC)
    occ_j = j_set_bitfield(j_init_occ(rspec_j), jnp.asarray(bitfield))
    key = jax.random.PRNGKey(13)
    u = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    bg, target = np.random.default_rng(9).uniform(
        size=(2, o.shape[0], 3)).astype(np.float32)

    def j_loss(p):
        out = j_render_rays(p, spec_j, rspec_j, occ_j, jnp.asarray(o),
                            jnp.asarray(d), training=True,
                            bg_color=jnp.asarray(bg), perturb_key=key)
        return ((out["image"] - target) ** 2).mean(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, bg_field))
    field = hash_field_from_jax(bg_field, spec_t, "cpu")
    out_t = render_rays(field, spec_t, rspec_t,
                        occupancy_from_jax(occ_j, "cpu"), _t(o), _t(d),
                        training=True, bg_color=_t(bg), u=_t(u))
    ((out_t["image"] - _t(target)) ** 2).mean().backward()
    ws = out_t["weights_sum"].detach().numpy()
    assert 0.05 < ws.mean() < 0.95 and (ws < 0.5).sum() >= 8
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=0, atol=IMG_TOL,
                                   err_msg=k)
    got = {"bg.encoder": field.bg.encoder.grad,
           **{f"bg.net.{i}": lin.weight.grad.T
              for i, lin in enumerate(field.bg.net)}}
    want = {"bg.encoder": g_j["bg"]["encoder"],
            **{f"bg.net.{i}": p["w"] for i, p in enumerate(g_j["bg"]["net"])}}
    for name, g in got.items():
        gw = np.asarray(want[name])
        scale = np.abs(gw).max()
        assert scale > 0, name
        atol = bg_grad_atol(field.bg.grid, scale, BG_GRAD_REL_ATOL,
                            table=name == "bg.encoder")
        diff = np.abs(g.numpy() - gw)
        assert (diff <= atol).all(), (name, float((diff / scale).max()))
