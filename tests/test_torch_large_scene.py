"""The large-scene configuration (bound 2 -> two occupancy cascades, the
geometric march dt_gamma 1/256, the background model bg_radius 32) through
pvd_tpu_torch's teacher and distill steps, occupancy upkeep and
checkpoints, against the JAX package (CPU), at a small width: a hash field
of 4 levels (2^14 table), grid 32, 128 march steps, a VM student at 32^3
(ranks 4 and 12), 256 rays of a 48x48 view, f32 heads.

The JAX steps run the plain lattice march (RenderSpec coarse_march=False,
so no multi-cascade probe masks); their draws are regenerated from their
keys in their order and handed to the port, whose march then takes the
same samples exactly.

Tolerances, as tests/test_torch_teacher.py and test_torch_distill.py hold
the steps without the background:
  * loss and logs: rtol 2e-5;
  * gradients: 2e-5 of each leaf's max |g| (+ rtol 1e-4 for the VM
    student, as test_torch_distill.py); the background's leaves widened for
    1-ulp polar differences (test_torch_background.bg_grad_atol);
  * params after the step: 1e-6 where |g| > 1e-3 x the leaf's max or
    g == 0 (Adam's first update is lr * sign(g));
  * occupancy: density grids rtol 1e-4, bits equal except within 1e-4 of
    the threshold; mark_untrained_grid and checkpoints exact.

The witness at the end trains the same small large-scene teacher with both
packages' Trainers.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.data.poses import pose_spherical
from pvd_tpu.engine import checkpoint as j_ckpt
from pvd_tpu.engine import optim as j_optim
from pvd_tpu.engine.train_steps import TrainState as JTrainState
from pvd_tpu.engine.train_steps import make_distill_step as j_make_distill
from pvd_tpu.engine.train_steps import make_occ_update as j_make_occ_update
from pvd_tpu.engine.train_steps import make_teacher_step as j_make_teacher
from pvd_tpu.models import init_field as j_init_field
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import get_rays as j_get_rays
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import mark_untrained_grid as j_mark
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine import optim
from pvd_tpu_torch.engine.train_steps import (TrainState, make_distill_step,
                                              make_occ_update,
                                              make_teacher_step)
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import (bg_grid_spec, param_group_label,
                                      trainable_label)
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import (field_from_tree, occupancy_from_jax,
                                  tree_from_field)
from pvd_tpu_torch.render.occupancy import (init_occupancy_state,
                                            mark_untrained_grid)
from test_torch_background import bg_grad_atol

torch.set_num_threads(1)

LOSS_RTOL, GRAD_REL_ATOL, GRAD_RTOL = 2e-5, 2e-5, 1e-4
PARAM_TOL, MASK_FRAC = 1e-6, 1e-3
GRID_RTOL = 1e-4

H = W = 48
INTR = (40.0, 40.0, 24.0, 24.0)
ITERS = 100
LARGE = dict(bound=2.0, dt_gamma=1 / 256, bg_radius=32.0)
CFG_KW = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
              precision="fp32", resolution0=32, **LARGE)
TEA_KW = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
              compute_dtype="float32", bound=2.0, bg_radius=32.0)
STU_KW = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
              vm_resolution=(32, 32, 32), compute_dtype="float32",
              bound=2.0, bg_radius=32.0)
KEY = jax.random.PRNGKey(21)


def _rspec_j(spr):
    """The JAX render spec on its plain lattice (no probe masks)."""
    return dataclasses.replace(JPVDConfig(**CFG_KW).render_spec(),
                               samples_per_ray=spr, coarse_march=False)


def _o1_tree(spec_kw, seed):
    """JAX init; O(1) hash and background tables, so that every level and
    the background matter."""
    tree = jax.tree_util.tree_map(np.asarray, j_init_field(
        jax.random.PRNGKey(seed), JModelSpec(**spec_kw)))
    rng = np.random.default_rng(seed)
    tree["bg"]["encoder"] = rng.uniform(
        -1, 1, tree["bg"]["encoder"].shape).astype(np.float32)
    if "encoder" in tree:
        tree["encoder"] = rng.uniform(
            -1, 1, tree["encoder"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def setup():
    rspec_j = _rspec_j(0.0)
    rng = np.random.default_rng(21)
    C = rspec_j.cascades
    assert C == 2
    occ_j = j_set_bitfield(j_init_occ(rspec_j), jnp.asarray(
        rng.uniform(size=C * 32 ** 3) < 0.1))
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    image = rng.uniform(size=(H * W, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=H * W)
    return dict(tea=_o1_tree(TEA_KW, 22), stu=_o1_tree(STU_KW, 23),
                occ_j=occ_j, pose=pose, image=image)


def _rays(key, pose):
    rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W,
                                           CFG_KW["num_rays"]))(
        key, jnp.asarray(pose))
    return rays


def _check_grads(got_tree, want_tree, bg_grid, rtol):
    for (path, gw), g in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                             jax.tree_util.tree_leaves(got_tree)):
        name = jax.tree_util.keystr(path)
        gw = np.asarray(gw)
        scale = np.abs(gw).max()
        assert scale > 0, name
        if name.startswith("['bg']"):
            atol = bg_grad_atol(bg_grid, scale, GRAD_REL_ATOL,
                                table="encoder" in name)
        else:
            atol = GRAD_REL_ATOL * scale
        diff = np.abs(g - gw)
        assert (diff <= atol + rtol * np.abs(gw)).all(), \
            (name, float((diff / scale).max()))


def _check_params(got_tree, want_tree, grads):
    n_held = n_all = 0
    for (path, pw), p, gw in zip(
            jax.tree_util.tree_flatten_with_path(want_tree)[0],
            jax.tree_util.tree_leaves(got_tree),
            jax.tree_util.tree_leaves(grads)):
        gw = np.asarray(gw)
        hold = (np.abs(gw) > MASK_FRAC * np.abs(gw).max()) | (gw == 0)
        np.testing.assert_allclose(p[hold], np.asarray(pw)[hold], rtol=0,
                                   atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        n_held += int(hold.sum())
        n_all += gw.size
    return n_held / n_all


@pytest.mark.parametrize("spr", [0.0, 16.0], ids=["padded", "compacted"])
def test_teacher_step_matches_jax(setup, spr):
    """One whole make_teacher_step: GT on white (a background model
    exists), the field's own background behind every ray, two cascades and
    the geometric lattice; loss and metrics, every gradient leaf (the
    background's included) and the params after AdamW."""
    s = setup
    cfg_j = JPVDConfig(**CFG_KW)
    spec_j = JModelSpec(**TEA_KW)
    tree = jax.tree_util.tree_map(jnp.asarray, s["tea"])
    j_opt = j_optim.build_optimizer(
        tree, j_label(spec_j), j_trainable(spec_j, ""),
        j_optim.exp_decay_schedule(1e-2, ITERS),
        j_optim.exp_decay_schedule(1e-3, ITERS))
    j_state = JTrainState(params=tree, opt_state=j_opt.init(tree),
                          occ=s["occ_j"], step=jnp.int32(0))
    j_step = j_make_teacher(spec_j, _rspec_j(spr), j_opt, cfg_j, INTR, H, W,
                            image_channels=4)
    j_new, _, j_metrics = j_step(j_state, jnp.asarray(s["pose"]),
                                 jnp.asarray(s["image"]),
                                 jnp.zeros(128 * 128, jnp.float32), KEY)
    j_grads = jax.jit(jax.grad(lambda p: _j_teacher_loss(s, p, spr, cfg_j,
                                                         spec_j)))(tree)

    k_rays, k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, 0), 3)
    rays = _rays(k_rays, s["pose"])
    n = CFG_KW["num_rays"]
    cfg = PVDConfig(**CFG_KW)
    spec = ModelSpec(**TEA_KW)
    field = field_from_tree(s["tea"], spec, "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(params, param_group_label(spec),
                                trainable_label(spec, ""),
                                optim.exp_decay_schedule(1e-2, ITERS),
                                optim.exp_decay_schedule(1e-3, ITERS))
    state = TrainState(field=field, opt_state=opt.init(params),
                       occ=occupancy_from_jax(s["occ_j"], "cpu"))
    rspec = dataclasses.replace(cfg.render_spec(), samples_per_ray=spr)
    step = make_teacher_step(spec, rspec, opt, cfg, INTR, H, W, 4,
                             device="cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        o=rays["rays_o"][0], d=rays["rays_d"][0],
        pix=s["image"][np.asarray(rays["inds"][0])],
        bg=jax.random.uniform(k_bg, (n, 3)),
        u=jax.random.uniform(k_perturb, (n,))).items()}
    state, metrics = step.core(state, t["o"], t["d"], t["pix"], t["bg"],
                               t["u"])
    keys = {"loss", "psnr", "budget_hit", "mask_frac"}
    keys |= {"compact_frac"} if spr else set()
    assert set(metrics) == set(j_metrics) == keys
    for k in keys:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(j_metrics["mask_frac"]) > 0.1
    if spr:
        assert 0.3 < float(j_metrics["compact_frac"]) < 1.0
    got_g = tree_from_field(state.field, grad=True)
    assert set(got_g) == set(j_grads) and "bg" in got_g
    _check_grads(got_g, j_grads, bg_grid_spec(), 0.0)
    assert _check_params(tree_from_field(state.field), j_new.params,
                         j_grads) > 0.75


def _j_teacher_loss(s, p, spr, cfg_j, spec_j):
    """The JAX teacher step's loss on the same draws, for its gradients."""
    from pvd_tpu.engine.train_steps import compose_gt, teacher_loss

    k_rays, k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, 0), 3)
    rays = j_get_rays(k_rays, jnp.asarray(s["pose"])[None], INTR, H, W,
                      cfg_j.num_rays)
    pix = jnp.asarray(s["image"])[rays["inds"][0]]
    gt, bg = compose_gt(pix, 4, spec_j.bg_radius, k_bg)
    loss, _ = teacher_loss(p, spec_j, _rspec_j(spr), cfg_j, s["occ_j"],
                           rays["rays_o"][0], rays["rays_d"][0], gt, bg,
                           k_perturb)
    return loss


def test_distill_step_matches_jax(setup):
    """One whole stage-3 make_distill_step, hash teacher -> VM student, both
    with a background model: each composites over its own background (the
    per-ray random bg is replaced), the teacher replays the student's
    samples on two cascades."""
    s = setup
    cfg_j = JPVDConfig(**CFG_KW, samples_per_ray=16.0)
    spec_tj, spec_sj = JModelSpec(**TEA_KW), JModelSpec(**STU_KW)
    stu = jax.tree_util.tree_map(jnp.asarray, s["stu"])
    tea = jax.tree_util.tree_map(jnp.asarray, s["tea"])
    rspec_j = _rspec_j(16.0)
    j_opt = j_optim.build_optimizer(
        stu, j_label(spec_sj), j_trainable(spec_sj, ""),
        j_optim.cosine_schedule(1e-2, ITERS),
        j_optim.cosine_schedule(1e-3, ITERS))
    j_state = JTrainState(params=stu, opt_state=j_opt.init(stu),
                          occ=s["occ_j"], step=jnp.int32(0))
    j_new, j_logs = j_make_distill(spec_sj, spec_tj, rspec_j, j_opt, cfg_j,
                                   INTR, H, W, stage=3)(
        j_state, tea, s["occ_j"], jnp.asarray(s["pose"]), KEY)
    k_rays, k_core = jax.random.split(jax.random.fold_in(KEY, 0))
    k_bg, k_perturb = jax.random.split(k_core)
    rays = _rays(k_rays, s["pose"])
    n = CFG_KW["num_rays"]
    bg = jax.random.uniform(k_bg, (n, 3))

    def f(p):
        from pvd_tpu.engine.train_steps import distill_loss

        return distill_loss(p, tea, spec_sj, spec_tj, rspec_j, cfg_j, 3,
                            s["occ_j"], s["occ_j"], rays["rays_o"][0],
                            rays["rays_d"][0], bg, k_perturb,
                            jnp.int32(0))[0]

    j_grads = jax.jit(jax.grad(f))(stu)

    cfg = PVDConfig(**CFG_KW, samples_per_ray=16.0)
    spec_t, spec_s = ModelSpec(**TEA_KW), ModelSpec(**STU_KW)
    teacher = field_from_tree(s["tea"], spec_t, "cpu").requires_grad_(False)
    student = field_from_tree(s["stu"], spec_s, "cpu")
    occ = occupancy_from_jax(s["occ_j"], "cpu")
    params = dict(student.named_parameters())
    opt = optim.build_optimizer(params, param_group_label(spec_s),
                                trainable_label(spec_s, ""),
                                optim.cosine_schedule(1e-2, ITERS),
                                optim.cosine_schedule(1e-3, ITERS))
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    step = make_distill_step(spec_s, spec_t, cfg.render_spec(), opt, cfg,
                             INTR, H, W, stage=3, device="cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        o=rays["rays_o"][0], d=rays["rays_d"][0], bg=bg,
        u=jax.random.uniform(k_perturb, (n,))).items()}
    state, logs = step.core(state, teacher, occ, t["o"], t["d"], t["bg"],
                            t["u"])
    assert set(logs) == set(j_logs)
    for k in j_logs:
        np.testing.assert_allclose(logs[k].item(), float(j_logs[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert 0.3 < float(j_logs["compact_frac"]) < 1.0
    got_g = tree_from_field(student, grad=True)
    assert "bg" in got_g
    _check_grads(got_g, j_grads, bg_grid_spec(), GRAD_RTOL)
    assert _check_params(tree_from_field(student), j_new.params,
                         j_grads) > 0.75


def _assert_bits_match(occ_t, occ_j, thresh_cap=10.0):
    grid = np.asarray(occ_j.density_grid).reshape(-1)
    thresh = min(float(occ_j.mean_density), thresh_cap)
    differ = occ_t.bitfield.numpy() != np.asarray(occ_j.bitfield)
    near = np.abs(grid - thresh) <= GRID_RTOL * abs(thresh) + 1e-6
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} bits"


def test_occupancy_upkeep_matches_jax(setup):
    """mark_untrained_grid (exact), then a full sweep and a partial update
    over both cascades, the JAX draws regenerated from its keys."""
    s = setup
    spec_j, rspec_j = JModelSpec(**TEA_KW), _rspec_j(0.0)
    poses = np.stack([nerf_matrix_to_ngp(pose_spherical(th, -30.0, 4.0),
                                         scale=0.8)
                      for th in (0.0, 90.0, 200.0)]).astype(np.float32)
    occ_j = j_mark(j_init_occ(rspec_j), poses, INTR, rspec_j)
    spec_t = ModelSpec(**TEA_KW)
    rspec_t = PVDConfig(**CFG_KW).render_spec()
    occ_t = mark_untrained_grid(init_occupancy_state(rspec_t, "cpu"), poses,
                                INTR, rspec_t)
    grid_j = np.asarray(occ_j.density_grid)
    np.testing.assert_array_equal(occ_t.density_grid.numpy(), grid_j)
    assert 0.01 < (grid_j == -1).mean() < 0.99  # seen and unseen cells
    tree = jax.tree_util.tree_map(jnp.asarray, s["tea"])
    field = field_from_tree(s["tea"], spec_t, "cpu")
    upd_j = j_make_occ_update(spec_j, rspec_j)
    upd_t = make_occ_update(spec_t, rspec_t, device="cpu")
    Hg, n = 32, 32 ** 3 // 4
    for full, key in ((True, jax.random.PRNGKey(5)),
                      (False, jax.random.PRNGKey(9))):
        new_j = upd_j(occ_j, tree, key, full=full)
        jitter, coords = [], []
        for cas in range(2):
            kc = jax.random.fold_in(key, cas)
            if full:
                jitter.append(np.asarray(jax.random.uniform(kc, (Hg ** 3, 3))))
                continue
            k1, k2, k3 = jax.random.split(kc, 3)
            rand = jax.random.randint(k1, (n, 3), 0, Hg)
            cdf = jnp.cumsum((occ_j.density_grid[cas].reshape(-1) > 0)
                             .astype(jnp.float32))
            u = jax.random.uniform(k2, (n,)) * jnp.maximum(cdf[-1], 1.0)
            flat = jnp.clip(jnp.searchsorted(cdf, u, side="left"), 0,
                            Hg ** 3 - 1)
            occd = jnp.stack([flat // (Hg * Hg), (flat // Hg) % Hg,
                              flat % Hg], -1)
            occd = jnp.where(cdf[-1] > 0, occd, rand)
            coords.append(np.asarray(jnp.concatenate([rand, occd])))
            jitter.append(np.asarray(jax.random.uniform(k3, (2 * n, 3))))
        new_t = upd_t(occ_t, field, full=full,
                      jitter=torch.from_numpy(np.stack(jitter)),
                      coords=None if full else torch.from_numpy(
                          np.stack(coords)))
        np.testing.assert_allclose(new_t.density_grid.numpy(),
                                   np.asarray(new_j.density_grid),
                                   rtol=GRID_RTOL, atol=1e-6)
        _assert_bits_match(new_t, new_j)
        bits = np.asarray(new_j.bitfield).reshape(2, -1)
        assert all(0.01 < b.mean() < 0.99 for b in bits)
        occ_j, occ_t = new_j, new_t


def test_checkpoints_with_bg_both_ways(setup, tmp_path):
    """A two-cascade checkpoint with a background model, written by each
    package and read by the other: params (bg included) and occupancy
    exact, the dilated bitfield the JAX package's."""
    s = setup
    spec = ModelSpec(**TEA_KW)
    path_j = j_ckpt.save_checkpoint(str(tmp_path / "j"), "hash", 7,
                                    s["tea"], s["occ_j"])
    got = ckpt.load_checkpoint(path_j, "cpu")
    field = field_from_tree(got["params"], spec, "cpu")
    back = tree_from_field(field)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(s["tea"])[0],
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    np.testing.assert_array_equal(got["occ"].bitfield.numpy(),
                                  np.asarray(s["occ_j"].bitfield))
    path_t = ckpt.save_checkpoint(str(tmp_path / "t"), "hash", 8, back,
                                  got["occ"])
    loaded = j_ckpt.load_checkpoint(path_t, dt_gamma=1 / 256)
    j_params, j_occ = loaded["params"], loaded["occ"]
    assert int(loaded["step"]) == 8
    flat_j = jax.tree_util.tree_flatten_with_path(j_params)[0]
    assert [p for p, _ in flat_j] == \
        [p for p, _ in jax.tree_util.tree_flatten_with_path(s["tea"])[0]]
    for (path, a), (_, b) in zip(flat_j, jax.tree_util.tree_flatten_with_path(
            s["tea"])[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    for f in ("bitfield", "bitfield_dilated", "density_grid"):
        np.testing.assert_array_equal(np.asarray(getattr(j_occ, f)),
                                      np.asarray(getattr(s["occ_j"], f)),
                                      err_msg=f)


# ---- witness: both packages' Trainers on the same small large scene ------

WITNESS_CFG = dict(iters=64, num_rays=256, grid_size=32, max_steps=128,
                   max_samples=48, samples_per_ray=16.0,
                   autotune_budget=False, update_extra_interval=8,
                   max_ray_batch=2048, density_thresh=0.01, lr=1e-2, seed=0,
                   hash_cell_levels=9, **LARGE)
WITNESS_SCENE = dict(n_train=8, n_val=1, n_test=2, H=32, W=32)
TOL_TRAIN_PSNR = 1.0


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    """Test PSNR of the same large-scene cell teacher (the configuration's
    teacher at a small grid and lattice) trained by each package's Trainer
    for 64 compacted steps (no autotune, so neither runs the padded
    warm-up: the JAX side's compiles stay few), each scored by its own
    evaluate."""
    from pvd_tpu.data.provider import NeRFDataset
    from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene
    from pvd_tpu.engine.trainer import Trainer as JTrainer

    root = j_make_scene(str(tmp_path_factory.mktemp("scene")),
                        **WITNESS_SCENE)
    jcfg = JPVDConfig(path=root, tensorboard=False,
                      workspace=str(tmp_path_factory.mktemp("ws_jax")),
                      **WITNESS_CFG)
    jax_tr = JTrainer(jcfg, mode="teacher")
    jax_tr.train(NeRFDataset(jcfg, "train"))
    j_stats = jax_tr.evaluate(NeRFDataset(jcfg, "test"))
    scene = make_synthetic_scene(**WITNESS_SCENE)
    pt_tr = Trainer(PVDConfig(
        **WITNESS_CFG, workspace=str(tmp_path_factory.mktemp("ws_torch"))),
        device="cpu")
    pt_tr.train(scene["train"])
    p_stats = pt_tr.evaluate(scene["test"])
    print({"jax": j_stats["psnr"], "torch": p_stats["psnr"]})
    return j_stats, p_stats, pt_tr


def test_trainers_agree_on_the_large_scene(witness):
    """Within 1 dB.  JAX's Trainer marches its multi-cascade probe path
    (per-cascade supercell masks), which may keep a few more samples than
    the exact lattice march the port runs (ROADMAP B3); its rays come from
    another generator.  Both runs trained the background model."""
    j_stats, p_stats, pt_tr = witness
    assert np.isfinite(p_stats["psnr"]) and j_stats["psnr"] > 12.0
    assert abs(p_stats["psnr"] - j_stats["psnr"]) <= TOL_TRAIN_PSNR, \
        (p_stats, j_stats)
    bg = pt_tr.state.field.bg
    assert bg is not None and pt_tr.rspec.cascades == 2
    path = ckpt.latest_checkpoint(os.path.join(pt_tr.workspace,
                                               "checkpoints"), "hash")
    assert "bg" in ckpt.load_checkpoint(path, "cpu")["params"]
