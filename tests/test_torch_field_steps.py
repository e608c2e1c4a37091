"""pvd_tpu_torch's teacher, host-batcher and distillation steps with the MLP
and plenoxel fields, against the JAX package's jitted steps (CPU).

Fields at test size: the MLP 4 layers x 32, PE 4, skip 1; the plenoxel
volume 12^3, degree 3, its values N(0, 0.5); a hash field of 4 levels and
a 2^14 table; a VM field at ranks 4/12 and (20, 24, 28).  A random 25%
occupancy grid (grid 32, 128 march steps), 256 rays of a random 48x48
RGBA image, 32 slots per ray, f32 heads; the padded path (samples_per_ray
0) and the compacted one.  The JAX steps' draws are regenerated from their
keys in their order and handed to the port's `step.core`, whose march
then takes the same samples exactly.

Tolerances (those of tests/test_torch_teacher.py and
tests/test_torch_distill.py):
  * loss and metrics: rtol 2e-5;
  * gradients: atol 2e-5 x the leaf's max |g| (plus rtol 1e-4 for the
    distill step), the same f32 sums in other orders, the plenoxel
    volume's gradient a scatter-add in another order;
  * params after one whole step: 1e-6, where the JAX gradient exceeds
    1e-3 x the leaf's max |g| or is exactly 0 (Adam's first update is
    lr * sign(g), which turns rounding noise around 0 into 2 * lr steps).
    At least 75% of the entries are held for the MLP, hash and VM fields
    and 20% for the plenoxel volume, whose corners reached only from the
    far side of a sample's cell carry gradients under the mark; every
    other entry within 2 * lr of JAX's.
The host step's rays: the port's `step.rays` (pixel_dirs, then the
rotation's FMA chain) against the JAX host step's jitted rays, where XLA
turns `/ fx` into `* (1 / fx)`: within 2.4e-7 (2 ulp of 1) in each
component of the unit direction; the whole step is compared on the JAX
step's own rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.data.poses import pose_spherical
from pvd_tpu.engine import optim as j_optim
from pvd_tpu.engine.train_steps import TrainState as JTrainState
from pvd_tpu.engine.train_steps import compose_gt as j_compose_gt
from pvd_tpu.engine.train_steps import distill_loss as j_distill_loss
from pvd_tpu.engine.train_steps import make_distill_step as j_make_distill
from pvd_tpu.engine.train_steps import make_teacher_step as j_make_teacher
from pvd_tpu.engine.train_steps import \
    make_teacher_step_host as j_make_host
from pvd_tpu.engine.train_steps import teacher_loss as j_teacher_loss
from pvd_tpu.models import api as j_api
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import get_rays as j_get_rays
from pvd_tpu.ops.rays import pixel_dirs as j_pixel_dirs
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.engine import optim
from pvd_tpu_torch.engine.train_steps import (TrainState, make_distill_step,
                                              make_teacher_step,
                                              make_teacher_step_host)
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import (field_from_tree, occupancy_from_jax,
                                  tree_from_field)

torch.set_num_threads(1)

LOSS_RTOL, GRAD_REL_ATOL, GRAD_RTOL = 2e-5, 2e-5, 1e-4
PARAM_TOL, MASK_FRAC = 1e-6, 1e-3
HELD = {"tensors": 0.2}  # else 0.75
LR = 1e-2
RAY_ATOL = 2.0 ** -22

H = W = 48
INTR = (40.0, 40.0, 24.0, 24.0)
ITERS = 100
N_RAYS = 256
CFG_KW = dict(num_rays=N_RAYS, grid_size=32, max_steps=128, max_samples=32,
              precision="fp32", resolution0=24)
SPECS = {
    "mlp": dict(model_type="mlp", nerf_layer_num=4, nerf_layer_wide=32,
                pe_multires=4, skip=1, compute_dtype="float32"),
    "tensors": dict(model_type="tensors", plenoxel_res=(12, 12, 12),
                    compute_dtype="float32"),
    "hash": dict(model_type="hash", hash_num_levels=4, hash_log2_size=14,
                 hash_desired_res=128, compute_dtype="float32"),
    "vm": dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
               vm_resolution=(20, 24, 28), compute_dtype="float32"),
}
KEY = jax.random.PRNGKey(11)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _tree(name, seed):
    """The JAX package's init of field `name`, with tables of order 1."""
    tree = _np(j_api.init_field(jax.random.PRNGKey(seed),
                                JModelSpec(**SPECS[name])))
    rng = np.random.default_rng(seed)
    if name == "tensors":
        tree["volume"] = rng.normal(
            scale=0.5, size=tree["volume"].shape).astype(np.float32)
    if name == "hash":
        tree["encoder"] = rng.uniform(-1, 1, tree["encoder"].shape) \
            .astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def world():
    """The occupancy grid, pose and image every step here shares."""
    rng = np.random.default_rng(5)
    occ_j = j_set_bitfield(j_init_occ(JPVDConfig(**CFG_KW).render_spec()),
                           jnp.asarray(rng.uniform(size=32 ** 3) < 0.25))
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    image = rng.uniform(size=(H * W, 4)).astype(np.float32)
    image[:, 3] = rng.choice([0.0, 1.0, 0.3], size=H * W)
    return dict(occ_j=occ_j, pose=pose, image=image,
                trees={n: _tree(n, i) for i, n in enumerate(SPECS)})


def _opts(spec_j, spec, tree, field, sched, lr=LR):
    """The same AdamW on both sides: the JAX optimizer and state, the
    port's optimizer and TrainState pieces."""
    j_opt = j_optim.build_optimizer(
        tree, j_label(spec_j), j_trainable(spec_j, ""),
        getattr(j_optim, sched)(lr, ITERS),
        getattr(j_optim, sched)(lr * 0.1, ITERS))
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        getattr(optim, sched)(lr, ITERS), getattr(optim, sched)(lr * 0.1,
                                                                ITERS))
    return j_opt, opt, opt.init(params)


def _check_update(field, want_grads, j_params, rtol=0.0, held=0.75):
    """Gradients (left in `.grad`) and the updated params against JAX's;
    at least `held` of the entries are held."""
    got_g, got_p = tree_from_field(field, grad=True), tree_from_field(field)
    assert [p for p, _ in _leaves(got_g)] == [p for p, _ in
                                              _leaves(want_grads)]
    n_held = n_all = 0
    for (path, gw), pw, g, p in zip(
            _leaves(want_grads), jax.tree_util.tree_leaves(j_params),
            jax.tree_util.tree_leaves(got_g),
            jax.tree_util.tree_leaves(got_p)):
        name = jax.tree_util.keystr(path)
        scale = np.abs(gw).max()
        np.testing.assert_allclose(g, gw, rtol=rtol,
                                   atol=GRAD_REL_ATOL * scale, err_msg=name)
        hold = (np.abs(gw) > MASK_FRAC * scale) | (gw == 0)
        np.testing.assert_allclose(p[hold], np.asarray(pw)[hold], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
        np.testing.assert_allclose(p, np.asarray(pw), rtol=0,
                                   atol=2 * LR + PARAM_TOL, err_msg=name)
        n_held += int(hold.sum())
        n_all += gw.size
    assert n_held > held * n_all


def _check_metrics(metrics, j_metrics, want_loss, keys):
    assert set(metrics) == set(j_metrics) == keys
    for k in keys:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(metrics["loss"].item(), want_loss,
                               rtol=LOSS_RTOL)


# ---- teacher steps ---------------------------------------------------------

def _teacher_case(w, name, spr, host):
    """One whole JAX teacher step (make_teacher_step, or
    make_teacher_step_host fed the same pose, pixel ids and pixels) and the
    port's step.core on its draws."""
    spec_j, spec = JModelSpec(**SPECS[name]), ModelSpec(**SPECS[name])
    cfg_j = JPVDConfig(**CFG_KW, samples_per_ray=spr)
    cfg = PVDConfig(**CFG_KW, samples_per_ray=spr)
    rspec_j = cfg_j.render_spec()
    tree = _jnp(w["trees"][name])
    field = field_from_tree(w["trees"][name], spec, "cpu")
    j_opt, opt, opt_state = _opts(spec_j, spec, tree, field,
                                  "exp_decay_schedule")
    j_state = JTrainState(params=tree, opt_state=j_opt.init(tree),
                          occ=w["occ_j"], step=jnp.int32(0))
    pose = jnp.asarray(w["pose"])
    key = jax.random.fold_in(KEY, 0)
    intr = tuple(float(v) for v in INTR)
    if host:
        k_bg, k_perturb = jax.random.split(key)
        inds = np.random.default_rng(7).integers(0, H * W, N_RAYS) \
            .astype(np.int32)
        pix = w["image"][inds]
        j_step = j_make_host(spec_j, rspec_j, j_opt, cfg_j, INTR, H, W,
                             image_channels=4)
        j_new, j_metrics = j_step(j_state, pose, jnp.asarray(inds),
                                  jnp.asarray(pix), KEY)
        # the JAX host step's rays, as its jit computes them
        d = np.asarray(jax.jit(lambda p, i: j_pixel_dirs(intr, i, H, W)
                               @ p[:3, :3].T)(pose, jnp.asarray(inds)))
        o = np.broadcast_to(w["pose"][:3, 3], d.shape).copy()
    else:
        k_rays, k_bg, k_perturb = jax.random.split(key, 3)
        j_step = j_make_teacher(spec_j, rspec_j, j_opt, cfg_j, INTR, H, W,
                                image_channels=4)
        j_new, _, j_metrics = j_step(j_state, pose, jnp.asarray(w["image"]),
                                     jnp.zeros(128 * 128, jnp.float32), KEY)
        rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W,
                                               N_RAYS))(k_rays, pose)
        inds = np.asarray(rays["inds"][0])
        pix = w["image"][inds]
        o, d = np.asarray(rays["rays_o"][0]), np.asarray(rays["rays_d"][0])
    bg = np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3)))
    u = np.asarray(jax.random.uniform(k_perturb, (N_RAYS,)))

    def loss_fn(p):
        gt, bg_j = j_compose_gt(jnp.asarray(pix), 4, spec_j.bg_radius, k_bg)
        loss, _ = j_teacher_loss(p, spec_j, rspec_j, cfg_j, w["occ_j"],
                                 jnp.asarray(o), jnp.asarray(d), gt, bg_j,
                                 k_perturb)
        return loss

    want_loss, want_grads = _np(jax.jit(jax.value_and_grad(loss_fn))(tree))
    make = make_teacher_step_host if host else make_teacher_step
    step = make(spec, cfg.render_spec(), opt, cfg, INTR, H, W,
                image_channels=4, device="cpu")
    state = TrainState(field=field, opt_state=opt_state,
                       occ=occupancy_from_jax(w["occ_j"], "cpu"))
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(o=o, d=d, pix=pix, bg=bg, u=u).items()}
    state, metrics = step.core(state, t["o"], t["d"], t["pix"], t["bg"],
                               t["u"])
    assert state.step == 1 and int(j_new.step) == 1
    keys = {"loss", "psnr", "budget_hit", "mask_frac"} | (
        {"compact_frac"} if spr else set())
    _check_metrics(metrics, j_metrics, float(want_loss), keys)
    assert float(j_metrics["mask_frac"]) > 0.1
    _check_update(field, want_grads, j_new.params,
                  held=HELD.get(name, 0.75))
    return step, inds, pix, d


@pytest.mark.parametrize("name,spr", [("mlp", 0.0), ("mlp", 16.0),
                                      ("tensors", 0.0), ("tensors", 16.0)],
                         ids=["mlp-padded", "mlp-compacted",
                              "tensors-padded", "tensors-compacted"])
def test_teacher_step_matches_jax(world, name, spr):
    """One whole teacher step of each new field, padded and compacted."""
    _teacher_case(world, name, spr, host=False)


@pytest.mark.parametrize("name", ["mlp", "tensors"])
def test_teacher_step_host_matches_jax(world, name):
    """make_teacher_step_host on the JAX host step's pose, pixel ids and
    pixels: the whole step on its rays; the port's own rays within
    RAY_ATOL of them; the port's step(...) with its own draws runs."""
    step, inds, pix, d_j = _teacher_case(world, name, 16.0, host=True)
    o, d = step.rays(world["pose"], inds)
    assert o.shape == d.shape == (N_RAYS, 3)
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0, atol=RAY_ATOL)
    np.testing.assert_array_equal(o.numpy()[0], world["pose"][:3, 3])
    spec = ModelSpec(**SPECS[name])
    field = field_from_tree(world["trees"][name], spec, "cpu")
    cfg = PVDConfig(**CFG_KW)
    _, opt, opt_state = _opts(JModelSpec(**SPECS[name]), spec,
                              _jnp(world["trees"][name]), field,
                              "exp_decay_schedule")
    host = make_teacher_step_host(spec, cfg.render_spec(), opt, cfg, INTR,
                                  H, W, image_channels=4, device="cpu")
    state = TrainState(field=field, opt_state=opt_state,
                       occ=occupancy_from_jax(world["occ_j"], "cpu"))
    state, metrics = host(state, world["pose"], inds, pix,
                          torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(metrics["loss"].item())


# ---- distillation steps -----------------------------------------------------

def _distill_case(w, tea, stu, stage):
    """One whole jitted JAX make_distill_step of `stage` against the port's
    distill_step_core on its draws; the gradients against JAX's
    distill_loss under value_and_grad."""
    spec_sj, spec_tj = JModelSpec(**SPECS[stu]), JModelSpec(**SPECS[tea])
    spec_s, spec_t = ModelSpec(**SPECS[stu]), ModelSpec(**SPECS[tea])
    cfg_j = JPVDConfig(**CFG_KW, samples_per_ray=8.0)
    cfg = PVDConfig(**CFG_KW, samples_per_ray=8.0)
    stu_tree, tea_tree = _jnp(w["trees"][stu]), _jnp(w["trees"][tea])
    student = field_from_tree(w["trees"][stu], spec_s, "cpu")
    teacher = field_from_tree(w["trees"][tea], spec_t, "cpu") \
        .requires_grad_(False)
    j_opt, opt, opt_state = _opts(spec_sj, spec_s, stu_tree, student,
                                  "cosine_schedule")
    j_state = JTrainState(params=stu_tree, opt_state=j_opt.init(stu_tree),
                          occ=w["occ_j"], step=jnp.int32(0))
    j_step = j_make_distill(spec_sj, spec_tj, cfg_j.render_spec(), j_opt,
                            cfg_j, INTR, H, W, stage=stage)
    pose = jnp.asarray(w["pose"])
    j_new, j_logs = j_step(j_state, tea_tree, w["occ_j"], pose, KEY)
    k_rays, k_core = jax.random.split(jax.random.fold_in(KEY, 0))
    rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W,
                                           N_RAYS))(k_rays, pose)
    k_bg, k_perturb = jax.random.split(k_core)
    o, d = rays["rays_o"][0], rays["rays_d"][0]
    bg = jax.random.uniform(k_bg, (N_RAYS, 3))

    def loss_fn(p):
        return j_distill_loss(p, tea_tree, spec_sj, spec_tj,
                              cfg_j.render_spec(), cfg_j, stage, w["occ_j"],
                              w["occ_j"], o, d, bg, k_perturb,
                              jnp.int32(0))

    (want_loss, (want_logs, _)), want_grads = _np(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(stu_tree))
    step = make_distill_step(spec_s, spec_t, cfg.render_spec(), opt, cfg,
                             INTR, H, W, stage=stage, device="cpu")
    state = TrainState(field=student, opt_state=opt_state,
                       occ=occupancy_from_jax(w["occ_j"], "cpu"))
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        o=o, d=d, bg=bg, u=jax.random.uniform(k_perturb, (N_RAYS,))).items()}
    state, logs = step.core(state, teacher, state.occ, t["o"], t["d"],
                            t["bg"], t["u"])
    assert state.step == 1 and int(j_new.step) == 1
    _check_metrics(logs, j_logs, float(want_loss), set(want_logs))
    assert float(want_logs["mask_frac"]) > 0.1
    _check_update(student, want_grads, j_new.params, rtol=GRAD_RTOL,
                  held=HELD.get(stu, 0.75))
    return logs


@pytest.mark.parametrize("tea,stu,stage", [
    ("hash", "mlp", 1), ("hash", "mlp", 2), ("hash", "mlp", 3),
    ("mlp", "tensors", 2), ("mlp", "tensors", 3),
    ("tensors", "vm", 2), ("tensors", "vm", 3)],
    ids=lambda v: str(v))
def test_distill_step_matches_jax(world, tea, stu, stage):
    """Each stage that runs for the pair (no stage 1 with a plenoxel side:
    it has no fea_sc, and the feature loss is then 0)."""
    logs = _distill_case(world, tea, stu, stage)
    if "tensors" in (tea, stu):
        assert logs["loss_fea_sc"].item() == 0.0
    else:
        assert logs["loss_fea_sc"].item() > 0.0


def test_stage1_refused_with_a_plenoxel_side():
    """make_distill_step refuses stage 1 when either side is a plenoxel
    field; stages 2 and 3 build."""
    cfg = PVDConfig(**CFG_KW)
    spec_t, spec_s = ModelSpec(**SPECS["mlp"]), ModelSpec(**SPECS["tensors"])
    for a, b in ((spec_s, spec_t), (spec_t, spec_s)):
        with pytest.raises(ValueError, match="plenoxel"):
            make_distill_step(a, b, cfg.render_spec(), None, cfg, INTR, H, W,
                              stage=1, device="cpu")
        for stage in (2, 3):
            make_distill_step(a, b, cfg.render_spec(), None, cfg, INTR, H,
                              W, stage=stage, device="cpu")
