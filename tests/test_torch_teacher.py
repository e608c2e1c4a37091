"""pvd_tpu_torch's teacher step and its helpers against the JAX package
(CPU).

A hash teacher (4 levels, 2^14 table, f32 heads) on a random 25% occupancy
grid (grid 32, 128 march steps); 256 rays of a random 48x48 RGBA image,
32 slots per ray; the padded path (samples_per_ray 0) and the compacted
one (16 samples per ray of budget).  The JAX step's draws are regenerated
from its key in its order (fold_in(key, step) -> k_rays, k_bg, k_perturb)
and handed to the port, whose march then takes the same samples exactly.

Tolerances:
  * loss and metrics: rtol 2e-5 (the same f32 ops summed in other orders
    through the field, the heads and the composite);
  * gradients: atol 2e-5 x the leaf's max |g| (the table gradient is a
    scatter-add in another order than XLA's);
  * params after one whole step: 1e-6, where the JAX gradient exceeds
    1e-3 x the leaf's max |g| or is exactly 0 (weight decay alone).
    Elsewhere Adam's first update, lr * sign(g) at eps 1e-15, turns
    rounding noise around 0 into steps 2 * lr apart.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.config import RenderSpec as JRenderSpec
from pvd_tpu.data.poses import pose_spherical as j_pose_spherical
from pvd_tpu.engine import autotune as j_autotune
from pvd_tpu.engine import optim as j_optim
from pvd_tpu.engine.train_steps import TrainState as JTrainState
from pvd_tpu.engine.train_steps import compose_gt as j_compose_gt
from pvd_tpu.engine.train_steps import make_teacher_step as j_make_step
from pvd_tpu.engine.train_steps import teacher_loss as j_teacher_loss
from pvd_tpu.models import hash_field as j_hash
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import get_rays as j_get_rays
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import mark_untrained_grid as j_mark
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu.utils.metrics import PSNRMeter as JPSNRMeter
from pvd_tpu.utils.misc import srgb_to_linear as j_srgb_to_linear
from pvd_tpu_torch.config import ModelSpec, PVDConfig, RenderSpec
from pvd_tpu_torch.data.poses import pose_spherical
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine import autotune, optim
from pvd_tpu_torch.engine.train_steps import (TrainState, compose_gt,
                                              make_teacher_step)
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import (hash_field_from_jax, hash_tree_from_field,
                                  occupancy_from_jax)
from pvd_tpu_torch.render.occupancy import (draw_occ_inputs,
                                            init_occupancy_state,
                                            mark_untrained_grid)
from pvd_tpu_torch.utils.metrics import PSNRMeter
from pvd_tpu_torch.utils.misc import srgb_to_linear

torch.set_num_threads(1)

LOSS_RTOL, GRAD_REL_ATOL = 2e-5, 2e-5
PARAM_TOL, MASK_FRAC = 1e-6, 1e-3

H = W = 48
INTR = (40.0, 40.0, 24.0, 24.0)
ITERS = 100
CFG_KW = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
              samples_per_ray=16.0, precision="fp32")
SPEC_KW = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
               compute_dtype="float32")
KEY = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def setup():
    cfg_j = JPVDConfig(**CFG_KW)
    spec_j = JModelSpec(**SPEC_KW)
    tree = jax.tree_util.tree_map(
        np.asarray, j_hash.init(jax.random.PRNGKey(2), spec_j))
    rng = np.random.default_rng(6)
    tree["encoder"] = rng.uniform(-1, 1, tree["encoder"].shape) \
        .astype(np.float32)
    occ_j = j_set_bitfield(j_init_occ(cfg_j.render_spec()), jnp.asarray(
        rng.uniform(size=32 ** 3) < 0.25))
    pose = nerf_matrix_to_ngp(j_pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    # RGBA with opaque, empty and partial pixels
    image = rng.uniform(size=(H * W, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=H * W)
    # the whole step's draws, regenerated in its order
    k_rays, k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, 0), 3)
    rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W,
                                           cfg_j.num_rays))(
        k_rays, jnp.asarray(pose))
    inds = np.asarray(rays["inds"][0])
    draws = dict(o=np.asarray(rays["rays_o"][0]),
                 d=np.asarray(rays["rays_d"][0]), pix=image[inds],
                 bg=np.asarray(jax.random.uniform(k_bg, (cfg_j.num_rays, 3))),
                 u=np.asarray(jax.random.uniform(k_perturb,
                                                 (cfg_j.num_rays,))),
                 k_bg=k_bg, k_perturb=k_perturb)
    return dict(cfg_j=cfg_j, spec_j=spec_j, tree=tree, occ_j=occ_j,
                pose=pose, image=image, draws=draws)


def _rspec_j(s, spr):
    return dataclasses.replace(s["cfg_j"].render_spec(), samples_per_ray=spr)


def _cfg_j(s, color_space):
    return dataclasses.replace(s["cfg_j"], color_space=color_space)


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX teacher_loss under value_and_grad, per (samples_per_ray,
    color space)."""
    s = setup
    dr = s["draws"]
    out = {}

    def get(spr, color_space):
        if (spr, color_space) in out:
            return out[spr, color_space]

        def f(p):
            pix = jnp.asarray(dr["pix"])
            if color_space == "linear":
                pix = jnp.concatenate([j_srgb_to_linear(pix[..., :3]),
                                       pix[..., 3:]], axis=-1)
            gt, bg = j_compose_gt(pix, 4, s["spec_j"].bg_radius, dr["k_bg"])
            loss, (o, _) = j_teacher_loss(
                p, s["spec_j"], _rspec_j(s, spr), _cfg_j(s, color_space),
                s["occ_j"],
                jnp.asarray(dr["o"]), jnp.asarray(dr["d"]), gt, bg,
                dr["k_perturb"])
            return loss, {"mask_frac": o["mask_frac"],
                          "budget_hit": o["budget_hit_frac"]}

        (loss, logs), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, s["tree"]))
        out[spr, color_space] = (
            float(loss), jax.tree_util.tree_map(np.asarray, logs),
            jax.tree_util.tree_map(np.asarray, grads))
        return out[spr, color_space]

    return get


def _port_step(s, spr, color_space):
    """The port's teacher_step_core on the regenerated draws."""
    cfg = PVDConfig(**CFG_KW, color_space=color_space)
    spec = ModelSpec(**SPEC_KW)
    field = hash_field_from_jax(s["tree"], spec, "cpu")
    occ = occupancy_from_jax(s["occ_j"], "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.exp_decay_schedule(1e-2, ITERS),
        optim.exp_decay_schedule(1e-3, ITERS))
    state = TrainState(field=field, opt_state=opt.init(params), occ=occ)
    rspec = dataclasses.replace(cfg.render_spec(), samples_per_ray=spr)
    step = make_teacher_step(spec, rspec, opt, cfg, INTR, H, W,
                             image_channels=4, device="cpu")
    dr = {k: torch.from_numpy(np.array(v)) for k, v in s["draws"].items()
          if not k.startswith("k_")}
    state, metrics = step.core(state, dr["o"], dr["d"], dr["pix"], dr["bg"],
                               dr["u"])
    return state, metrics


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("spr,color_space", [(0.0, "srgb"), (16.0, "srgb"),
                                             (16.0, "linear")],
                         ids=["padded", "compacted", "compacted-linear"])
def test_teacher_step_matches_jax(setup, jax_grads, spr, color_space):
    """One whole JAX make_teacher_step against the port's step.core on the
    same draws: loss and metrics, every gradient leaf (the hash table
    included), and the params after the AdamW update; the last case
    trains on linear-space GT (color_space "linear")."""
    s = setup
    tree = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    j_opt = j_optim.build_optimizer(
        tree, j_label(s["spec_j"]), j_trainable(s["spec_j"], ""),
        j_optim.exp_decay_schedule(1e-2, ITERS),
        j_optim.exp_decay_schedule(1e-3, ITERS))
    j_state = JTrainState(params=tree, opt_state=j_opt.init(tree),
                          occ=s["occ_j"], step=jnp.int32(0))
    j_step = j_make_step(s["spec_j"], _rspec_j(s, spr), j_opt,
                         _cfg_j(s, color_space), INTR, H, W,
                         image_channels=4)
    j_new, _, j_metrics = j_step(j_state, jnp.asarray(s["pose"]),
                                 jnp.asarray(s["image"]),
                                 jnp.zeros(128 * 128, jnp.float32), KEY)
    want_loss, want_logs, want_grads = jax_grads(spr, color_space)

    state, metrics = _port_step(s, spr, color_space)
    assert state.step == 1 and int(j_new.step) == 1
    keys = {"loss", "psnr", "budget_hit", "mask_frac"}
    keys |= {"compact_frac"} if spr else set()
    assert set(metrics) == set(j_metrics) == keys
    for k in keys:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(metrics["loss"].item(), want_loss,
                               rtol=LOSS_RTOL)
    # a real batch: a quarter of the slots filled, under the budget
    assert float(want_logs["mask_frac"]) > 0.1
    if spr:
        assert 0.3 < float(j_metrics["compact_frac"]) < 1.0

    got_g = hash_tree_from_field(state.field, grad=True)
    got_p = hash_tree_from_field(state.field)
    n_held = n_all = 0
    for (path, gw), (_, pw), g, p in zip(
            _leaves(want_grads), _leaves(j_new.params),
            jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(got_p)):
        name = jax.tree_util.keystr(path)
        scale = np.abs(gw).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, gw, rtol=0, atol=GRAD_REL_ATOL * scale,
                                   err_msg=name)
        hold = (np.abs(gw) > MASK_FRAC * scale) | (gw == 0)
        np.testing.assert_allclose(p[hold], np.asarray(pw)[hold], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        n_held += int(hold.sum())
        n_all += gw.size
    # table rows reached only by far corners carry gradients under the
    # noise mark: ~80% of all entries are held
    assert n_held > 0.75 * n_all
    # the table's gradient reaches the dense level and the hashed ones
    enc = got_g["encoder"]
    offsets = state.field.grid.offsets
    for lvl in range(state.field.grid.num_levels):
        assert np.abs(enc[offsets[lvl]:offsets[lvl + 1]]).max() > 0


@pytest.mark.parametrize("channels,bg_radius", [(4, -1.0), (4, 1.0),
                                                (3, -1.0)],
                         ids=["rgba-random-bg", "rgba-white", "rgb"])
def test_compose_gt_matches_jax(channels, bg_radius):
    rng = np.random.default_rng(1)
    pix = rng.uniform(size=(64, channels)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    bg = np.array(jax.random.uniform(key, (64, 3)))
    gt_j, bg_j = j_compose_gt(jnp.asarray(pix), channels, bg_radius, key)
    gt, bg_t = compose_gt(torch.from_numpy(pix), channels, bg_radius,
                          torch.from_numpy(bg))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gt_j), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(bg_t, np.float32),
                               np.asarray(bg_j, np.float32), rtol=0)


def test_color_space_matches_jax():
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_allclose(srgb_to_linear(torch.from_numpy(x)).numpy(),
                               np.asarray(j_srgb_to_linear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_psnr_meter_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(size=(2, 3, 8, 8, 3)).astype(np.float32)
    m, mj = PSNRMeter(), JPSNRMeter()
    for x, y in zip(a, b):
        m.update(x, y)
        mj.update(x, y)
    assert m.measure() == mj.measure() and m.report() == mj.report()


@pytest.mark.parametrize("theta,phi", [(0.0, -30.0), (123.4, -57.0),
                                       (-170.0, -10.0)])
def test_pose_spherical_matches_jax(theta, phi):
    np.testing.assert_array_equal(pose_spherical(theta, phi, 4.0),
                                  j_pose_spherical(theta, phi, 4.0))


@pytest.mark.parametrize("grid,bound,scale_fx", [(32, 1.0, 1.0),
                                                 (32, 1.0, 3.0),
                                                 (32, 2.0, 2.0)],
                         ids=["wide", "narrow", "two-cascades"])
def test_mark_untrained_grid_matches_jax(grid, bound, scale_fx):
    """Exact: the same cells marked -1 (narrow frusta leave many unseen)."""
    sc = make_synthetic_scene(n_train=5, n_val=0, n_test=0, H=16, W=16,
                              seed=2)["train"]
    intr = sc.intrinsics * np.float32([scale_fx, scale_fx, 1, 1])
    jr = JRenderSpec(grid_size=grid, bound=bound)
    rs = RenderSpec(grid_size=grid, bound=bound)
    want = np.asarray(j_mark(j_init_occ(jr), sc.poses, intr, jr)
                      .density_grid)
    got = mark_untrained_grid(init_occupancy_state(rs, "cpu"), sc.poses,
                              intr, rs).density_grid.numpy()
    np.testing.assert_array_equal(got, want)
    if scale_fx > 1:
        assert 0.05 < (want == -1).mean() < 0.95


def test_autotune_matches_jax():
    """choose_buckets and retune equal over a grid of statistics and
    starting buckets."""
    n = 0
    for s_max in (16, 48, 96, 256):
        for spr in (0.0, 4.0, 16.0, 96.0):
            rs = RenderSpec(max_samples=s_max, samples_per_ray=spr)
            rj = JRenderSpec(max_samples=s_max, samples_per_ray=spr)
            for hit in (0.0, 0.01, 0.1, 0.3, 0.9):
                for frac in (0.01, 0.05, 0.2, 0.4, 0.8, 1.0):
                    for shrink in (True, False):
                        got = autotune.choose_buckets(rs, hit, frac, shrink)
                        want = j_autotune.choose_buckets(rj, hit, frac,
                                                         shrink)
                        assert got == want
                        new = autotune.retune(rs, hit, frac, shrink)
                        new_j = j_autotune.retune(rj, hit, frac, shrink)
                        assert (new is None) == (new_j is None)
                        if new is not None:
                            assert (new.max_samples, new.samples_per_ray) \
                                == (new_j.max_samples, new_j.samples_per_ray)
                            n += 1
    assert n > 50  # the grid moves the buckets both ways
    assert autotune.SMAX_BUCKETS == j_autotune.SMAX_BUCKETS
    assert autotune.SPR_BUCKETS == j_autotune.SPR_BUCKETS


def test_synthetic_scene_matches_jax():
    """The arrays equal what JAX's make_synthetic_scene writes and its
    NeRFDataset reads back (PNG round trip, NGP poses, intrinsics)."""
    from pvd_tpu.config import PVDConfig as JCfg
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene

    with tempfile.TemporaryDirectory() as root:
        j_make_scene(root, n_train=3, n_val=1, n_test=2, H=20, W=24, seed=4,
                     textured=True)
        got = make_synthetic_scene(n_train=3, n_val=1, n_test=2, H=20, W=24,
                                   seed=4, textured=True)
        for split in ("train", "val", "test"):
            ds = NeRFDataset(JCfg(path=root), split)
            sp = got[split]
            assert (sp.H, sp.W, len(sp)) == (ds.H, ds.W, len(ds))
            np.testing.assert_array_equal(sp.poses, ds.poses)
            np.testing.assert_array_equal(sp.images, ds.images)
            np.testing.assert_array_equal(sp.intrinsics, ds.intrinsics)
            np.testing.assert_array_equal(sp.images_flat(), ds.images_flat())


def test_draw_occ_inputs():
    """The occupancy draws: full mode jitters every cell; partial mode
    takes H^3/4 uniform cells, then H^3/4 cells of the occupied set (the
    uniform ones again when nothing is occupied)."""
    rs = RenderSpec(grid_size=16, bound=2.0)
    occ = init_occupancy_state(rs, "cpu")
    gen = torch.Generator().manual_seed(0)
    jitter, coords = draw_occ_inputs(gen, occ, rs, full=True)
    assert coords is None and jitter.shape == (2, 16 ** 3, 3)
    assert 0.0 <= float(jitter.min()) and float(jitter.max()) < 1.0
    n = 16 ** 3 // 4
    jitter, coords = draw_occ_inputs(gen, occ, rs, full=False)
    assert jitter.shape == coords.shape == (2, 2 * n, 3)
    assert torch.equal(coords[:, :n], coords[:, n:])  # nothing occupied
    grid = torch.full_like(occ.density_grid, -1.0)
    grid[0, 3, 4, 5] = 2.0
    grid[0, 7, 0, 1] = 0.5
    grid[1, 15, 15, 15] = 1.0
    _, coords = draw_occ_inputs(gen, occ.replace(density_grid=grid), rs,
                                full=False)
    c0 = {tuple(c) for c in coords[0, n:].tolist()}
    assert c0 == {(3, 4, 5), (7, 0, 1)}
    assert {tuple(c) for c in coords[1, n:].tolist()} == {(15, 15, 15)}
    assert int(coords[:, :n].min()) >= 0 and int(coords[:, :n].max()) < 16
