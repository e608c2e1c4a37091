"""pvd_tpu_torch's background sphere model against the JAX package (CPU).

The background model (bg_radius > 0) maps each ray's exit point on a sphere
of radius bg_radius to polar coordinates, encodes them on a 2-D hash grid
(4 levels x 2 channels) and runs SH(d) ⊕ hash(polar) through a bias-free
MLP with a final sigmoid (pvd_tpu/models/api.py:102-137).

Tolerances:
  * polar coordinates: 1e-6 (the same f32 ops; XLA:CPU's FMA contractions
    reproduced, atan2 and sqrt from two libraries);
  * the 2-D encode: 1e-6 on O(1) tables (4 corners summed in another order
    than XLA's packed dense matmul);
  * its table gradient: 1e-5 of the max |g| (a scatter-add in another
    order);
  * background RGB on the same polar coordinates: 1e-6 (the same encode,
    f32 MLP sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.engine import checkpoint as j_ckpt
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.models.api import background_rgb as j_background_rgb
from pvd_tpu.models.api import bg_grid_spec as j_bg_grid_spec
from pvd_tpu.ops.aabb import polar_from_ray as j_polar_from_ray
from pvd_tpu.ops.hashgrid import hash_encode as j_hash_encode
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import background_rgb, bg_grid_spec
from pvd_tpu_torch.ops.aabb import polar_from_ray
from pvd_tpu_torch.ops.hashgrid import (hash_encode, hash_encode_bwd,
                                        hash_encode_bwd_plain,
                                        hash_encode_fwd)
from pvd_tpu_torch.params import field_from_tree, tree_from_field

torch.set_num_threads(1)

POLAR_TOL, ENC_TOL, BWD_REL_TOL, RGB_TOL = 1e-6, 1e-6, 1e-5, 1e-6
RADIUS = 32.0
SMALL_HASH = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
                  compute_dtype="float32", bg_radius=RADIUS)
SMALL_VM = dict(model_type="vm", vm_sigma_rank=2, vm_color_rank=3,
                vm_resolution=(6, 7, 8), compute_dtype="float32",
                bg_radius=RADIUS)


def bg_grad_atol(grid, scale: float, rel: float, table: bool = True):
    """Absolute tolerance of a background leaf's gradient when the two
    packages' polar coordinates may differ by 1 ulp.  Inside a jitted
    render XLA:CPU fuses phi / pi into the encode's (polar + 1) / 2 as one
    FMA and divides with ~1-ulp accuracy, so a ray's polar coordinate can
    land 1 ulp (<= 2^-24 in [0, 1]) away from the port's correctly rounded
    one.  That moves a level-l corner weight by up to level_scale(l) *
    2^-24 (1.2e-4 at the 2048-cell level 3) in each of the two dimensions,
    and the level-l features with it.  `table`: per-row tolerances [T, 1]
    of the table, rel + 2 * level_scale(l) * 2^-24 of the leaf's max |g|
    for level l's rows; else one number for an MLP leaf, whose input
    carries every level's features (the finest level's allowance)."""
    def allow(lvl):
        return (rel + 2.0 * grid.level_scale(lvl) * 2.0 ** -24) * scale

    if not table:
        return allow(grid.num_levels - 1)
    atol = np.empty((grid.table_size, 1), np.float32)
    for lvl in range(grid.num_levels):
        atol[grid.offsets[lvl]:grid.offsets[lvl + 1]] = allow(lvl)
    return atol


def _rays(rng, n):
    """Rays from inside the sphere (the cameras of a large scene) and a few
    near its surface, in every direction; some axis-aligned."""
    o = rng.normal(size=(n, 3)) * rng.choice([0.5, 3.0, 20.0], size=(n, 1))
    d = rng.normal(size=(n, 3))
    d[:4] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0], [0, -1, 0]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_polar_from_ray_matches_jax():
    o, d = _rays(np.random.default_rng(0), 4000)
    want = np.asarray(jax.jit(lambda o, d: j_polar_from_ray(o, d, RADIUS))(
        o, d))
    got = polar_from_ray(torch.from_numpy(o), torch.from_numpy(d),
                         RADIUS).numpy()
    assert got.shape == (4000, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=POLAR_TOL)
    assert (np.abs(got) <= 1.0).all()
    # the polar range is covered: up (theta -1) to down (theta 1), all phi
    assert got[:, 0].min() < -0.9 and got[:, 0].max() > 0.9
    assert got[:, 1].min() < -0.9 and got[:, 1].max() > 0.9


def test_bg_grid_spec_layout_matches_jax():
    """4 levels x 2 channels at resolutions 16/81/407/2048: levels 0-2
    dense, level 3 hashed into 2^19 rows; 697,776 rows (5.6 MB in f32)."""
    ts, js = bg_grid_spec(), j_bg_grid_spec()
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    assert list(ts.offsets) == [0, 296, 7024, 173488, 697776]
    assert ts.table_size == js.table_size == 697_776
    assert ts.output_dim == js.output_dim == 8
    assert [ts.level_resolution(lv) for lv in range(4)] == [16, 81, 407, 2048]
    for lv in range(4):
        assert ts.level_scale(lv) == js.level_scale(lv)
        assert ts.level_is_hashed(lv) == js.level_is_hashed(lv) == (lv == 3)


def _enc_inputs(seed):
    """O(1) table; points inside, on the edge of and just outside the unit
    square; O(1) upstream gradient."""
    spec = bg_grid_spec()
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    x[:7] = [[0, 0], [1, 1], [0, 1], [1, 0.25], [-1e-3, 0.5], [0.5, 1.001],
             [1.0 + 1e-7, 0.5]]
    g = rng.normal(size=(600, spec.output_dim)).astype(np.float32)
    return spec, table, x, g


def test_hash_encode_2d_matches_jax():
    spec, table, x, _ = _enc_inputs(0)
    want = np.asarray(jax.jit(lambda t, x: j_hash_encode(
        t, x, j_bg_grid_spec()))(table, x))
    got = hash_encode(torch.from_numpy(table), torch.from_numpy(x), spec)
    assert got.shape == (600, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENC_TOL)
    assert (got[4:7] == 0).all() and (got[7:].abs().sum(-1) > 0).all()
    # the K12 wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(
        hash_encode_fwd(torch.from_numpy(table), torch.from_numpy(x),
                        spec).numpy(), got.numpy())


@pytest.mark.parametrize("n", chip_smoke.HARD_COUNTS)
def test_hash_encode_2d_hard_points_match_jax(n):
    """The plain 2-D encode (K12's reference on the card) against JAX's on
    K12's hard points (`chip_smoke.hard_points`, the ones the card holds
    K12 to): ragged counts, polar coordinates 0 and 1, points just outside
    [0, 1]^2 and NaN points, alone and beside a coordinate outside.  A NaN
    point's row is NaN, an outside point's 0."""
    spec = bg_grid_spec()
    table = np.random.default_rng(n).uniform(
        -1, 1, (spec.table_size, 2)).astype(np.float32)
    x = chip_smoke.hard_points(n, 2)
    nan = np.isnan(x).any(-1)
    outside = ((x < 0) | (x > 1)).any(-1) & ~nan
    if n > 1:
        assert nan.any() and outside.any() and (x == 0).any() \
            and (x == 1).any()
    want = np.asarray(jax.jit(lambda t, x: j_hash_encode(
        t, x, j_bg_grid_spec()))(table, x))
    got = hash_encode_fwd(torch.from_numpy(table), torch.from_numpy(x),
                          spec).numpy()
    assert got.shape == (n, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_TOL)
    assert np.isnan(got).all(-1).tolist() == nan.tolist()
    assert (got[outside] == 0).all() and not np.isnan(got[~nan]).any()


@pytest.mark.parametrize("seed", [0, 1, "one_cell", "edge"])
def test_hash_encode_2d_bwd_matches_jax_vjp(seed):
    """The plain table gradient (K13's reference on the card) against JAX's
    VJP: seeded points (`_enc_inputs`), and K13's contention and edge
    inputs (chip_smoke.py's `k13_hard_inputs`, the ones the card holds K13
    to)."""
    if isinstance(seed, str):
        spec = bg_grid_spec()
        x, g = chip_smoke.k13_hard_inputs()[seed]
        table = np.random.default_rng(2).uniform(
            -1, 1, (spec.table_size, 2)).astype(np.float32)
        if seed == "one_cell":  # every point in level 0's cell (7, 7)
            pos = x * np.float32(15.0) + np.float32(0.5)
            assert (np.floor(pos) == 7).all()
        else:
            assert ((x == 0) | (x == 1)).any(-1).sum() >= 3 * 4096 // 8
            assert ((x < 0) | (x > 1)).any(-1).sum() == 8
            assert (np.abs(g).sum(-1) == 0).sum() == -(-4096 // 3)
    else:
        spec, table, x, g = _enc_inputs(seed)
    _, vjp = jax.vjp(lambda t: j_hash_encode(t, jnp.asarray(x),
                                             j_bg_grid_spec()),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                spec).numpy()
    assert got.shape == want.shape == table.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BWD_REL_TOL * np.abs(want).max())
    for lv in range(4):  # every level, dense and hashed, gets gradient
        assert np.abs(got[spec.offsets[lv]:spec.offsets[lv + 1]]).sum() > 0
    # through the autograd Function (K13's plain version on the CPU)
    t = torch.from_numpy(table).requires_grad_()
    hash_encode(t, torch.from_numpy(x), spec).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), got)
    np.testing.assert_array_equal(
        hash_encode_bwd(torch.from_numpy(x), torch.from_numpy(g),
                        spec).numpy(), got)


def _jax_tree(spec_kw, seed):
    """JAX params with a background model; O(1) background table so the
    encode matters (the 1e-4 init makes the background ~constant)."""
    tree = jax.tree_util.tree_map(np.asarray, j_init_field(
        jax.random.PRNGKey(seed), JModelSpec(**spec_kw)))
    tree["bg"]["encoder"] = np.random.default_rng(seed).uniform(
        -1, 1, tree["bg"]["encoder"].shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("spec_kw", [SMALL_HASH, SMALL_VM],
                         ids=["hash", "vm"])
def test_background_rgb_matches_jax(spec_kw):
    """Both packages' background on the same polar coordinates (a 1-ulp
    polar difference moves a level-3 feature by ~1e-4 of the table's
    scale, test_polar_from_ray_matches_jax holds the polar part)."""
    tree = _jax_tree(spec_kw, 2)
    o, d = _rays(np.random.default_rng(3), 500)
    polar = polar_from_ray(torch.from_numpy(o), torch.from_numpy(d), RADIUS)
    spec_j = JModelSpec(**spec_kw)
    want = np.asarray(jax.jit(lambda p, pol, d: j_background_rgb(
        p, spec_j, pol, d))(jax.tree_util.tree_map(jnp.asarray, tree),
                            polar.numpy(), d))
    spec = ModelSpec(**spec_kw)
    field = field_from_tree(tree, spec, "cpu")
    got = background_rgb(field, spec, polar, torch.from_numpy(d))
    assert got.shape == (500, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RGB_TOL)
    assert want.std() > 0.01  # the colors vary with the direction


@pytest.mark.parametrize("spec_kw", [SMALL_HASH, SMALL_VM],
                         ids=["hash", "vm"])
def test_params_carry_the_bg_subtree_both_ways(spec_kw):
    tree = _jax_tree(spec_kw, 5)
    spec = ModelSpec(**spec_kw)
    field = field_from_tree(tree, spec, "cpu")
    assert field.bg is not None
    assert {n for n, _ in field.named_parameters() if n.startswith("bg.")} \
        == {"bg.encoder", "bg.net.0.weight", "bg.net.1.weight"}
    back = tree_from_field(field)
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    # a tree without bg does not load into a field with one, nor back
    with pytest.raises(ValueError, match="bg"):
        field_from_tree({k: v for k, v in tree.items() if k != "bg"}, spec,
                        "cpu")
    no_bg = ModelSpec(**{**spec_kw, "bg_radius": -1.0})
    with pytest.raises(ValueError, match="bg"):
        field_from_tree(tree, no_bg, "cpu")


def test_load_teacher_warm_starts_the_student_bg(tmp_path):
    """A JAX-written hash checkpoint with a background model: the distill
    Trainer's teacher holds it, and the VM student's background starts as
    an exact copy (same paths and shapes, checkpoint.py:137-154)."""
    tree = _jax_tree(dict(bg_radius=RADIUS), 7)  # PVDConfig's hash width
    cfg_kw = dict(grid_size=16, max_steps=64, bg_radius=RADIUS,
                  model_type="vm", teacher_type="hash", resolution0=8,
                  workspace=str(tmp_path))
    from pvd_tpu.config import RenderSpec as JRenderSpec

    occ = j_init_occ(JRenderSpec(grid_size=16, max_steps=64))
    path = j_ckpt.save_checkpoint(str(tmp_path / "ck"), "hash", 3, tree, occ)
    stu = Trainer(PVDConfig(**cfg_kw), mode="distill", device="cpu")
    stu.load_teacher(path)
    t_bg, s_bg = stu.teacher.bg, stu.state.field.bg
    assert torch.equal(t_bg.encoder, torch.from_numpy(tree["bg"]["encoder"]))
    assert torch.equal(s_bg.encoder, t_bg.encoder)
    for a, b in zip(s_bg.net, t_bg.net):
        assert torch.equal(a.weight, b.weight)
    # the student's background trains: its leaves are in the optimizer
    assert s_bg.encoder.requires_grad


def test_synthetic_scene_over_a_sky_dome():
    """sky_radius > 0: the same spheres, RGB over a dome whose color
    varies with where each ray leaves it (the large-scene phase's scene);
    sky_radius 0 keeps the JAX package's RGBA scene."""
    kw = dict(n_train=3, n_val=0, n_test=1, H=24, W=24, seed=3)
    plain = make_synthetic_scene(**kw)
    sky = make_synthetic_scene(**kw, sky_radius=RADIUS / 0.8)
    for split in ("train", "test"):
        a, b = plain[split].images, sky[split].images
        assert a.shape[-1] == 4 and b.shape[-1] == 3
        obj = a[..., 3] == 1.0
        assert 0.05 < obj.mean() < 0.95
        np.testing.assert_array_equal(b[obj], a[..., :3][obj])
        np.testing.assert_array_equal(sky[split].poses, plain[split].poses)
    back = sky["train"].images[plain["train"].images[..., 3] == 0.0]
    assert (back.std(0) > 0.02).all() and (back < 0.99).all()
