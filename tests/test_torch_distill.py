"""pvd_tpu_torch's distillation step against the JAX package (CPU).

A hash teacher (4 levels, 2^14 table; or, for the whole step, the
cell-mode teacher of tests/test_cell_mode.py: 6 levels, base 4, desired
64, a 2^9 table, the 2 finest hashed levels cell-packed) and a VM student at a non-cubic
resolution (ranks 4 and 12) share an occupancy grid (grid 32, 128 march
steps); 256 rays, 32 slots per ray, 8 samples per ray of budget, f32 heads.
The JAX package's draws are regenerated from its key in its order
(fold_in(key, step) -> k_rays, k_core; k_core -> k_bg, k_perturb) and
handed to the port, whose march then takes the same samples exactly.

Tolerances:
  * loss and logs: rtol 2e-5 (the same f32 ops summed in other orders
    through two fields, the heads and the composite);
  * student gradients: atol 2e-5 x the leaf's max |g| plus rtol 1e-4 (the
    sums reach the tables as scatter-adds in another order, and the loss
    mixes terms of magnitudes 1e-3 to 1; measured: up to 6.3e-6 x max);
  * updated params after one whole step: 1e-6, where the JAX gradient
    exceeds 1e-3 x the leaf's max |g|, and where it is exactly 0 (weight
    decay alone).  Elsewhere Adam's first update, lr * sign(g) at eps
    1e-15, turns rounding noise around 0 into steps 2 * lr apart.
"""

import dataclasses

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
from pvd_tpu.engine.train_steps import distill_loss as j_distill_loss
from pvd_tpu.engine.train_steps import make_distill_step as j_make_step
from pvd_tpu.engine.train_steps import masked_loss as j_masked_loss
from pvd_tpu.engine.train_steps import rgb_loss as j_rgb_loss
from pvd_tpu.models import hash_field as j_hash
from pvd_tpu.models import vm_field as j_vm
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import get_rays as j_get_rays
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.engine import optim
from pvd_tpu_torch.engine.train_steps import (TrainState, distill_loss,
                                              make_distill_step, masked_loss,
                                              rgb_loss)
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.ops.rays import nerf_matrix_to_ngp
from pvd_tpu_torch.params import (hash_field_from_jax, occupancy_from_jax,
                                  vm_field_from_jax, vm_tree_from_field)

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
GRAD_REL_ATOL, GRAD_RTOL = 2e-5, 1e-4
PARAM_TOL, MASK_FRAC = 1e-6, 1e-3

H = W = 48
INTR = (40.0, 40.0, 24.0, 24.0)
ITERS = 100
CFG_KW = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
              samples_per_ray=8.0, precision="fp32", resolution0=24)
TEA_KW = dict(hash_num_levels=4, hash_log2_size=14, hash_desired_res=128,
              compute_dtype="float32")
STU_KW = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
              vm_resolution=(20, 24, 28), compute_dtype="float32")
CELL_TEA_KW = dict(hash_num_levels=6, hash_base_res=4, hash_desired_res=64,
                   hash_log2_size=9, hash_cell_levels=2,
                   compute_dtype="float32")
KEY = jax.random.PRNGKey(7)


def _build(tea_kw):
    cfg_j = JPVDConfig(**CFG_KW)
    rspec_j = cfg_j.render_spec()
    spec_tj, spec_sj = JModelSpec(**tea_kw), JModelSpec(**STU_KW)
    tea = jax.tree_util.tree_map(
        np.asarray, j_hash.init(jax.random.PRNGKey(3), spec_tj))
    rng = np.random.default_rng(3)
    for k in ("encoder", "encoder_cell"):
        if k in tea:
            tea[k] = rng.uniform(-1, 1, tea[k].shape).astype(np.float32)
    stu = jax.tree_util.tree_map(
        np.asarray, j_vm.init(jax.random.PRNGKey(4), spec_sj))
    occ_j = j_set_bitfield(j_init_occ(rspec_j), jnp.asarray(
        rng.uniform(size=32 ** 3) < 0.25))
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    # the whole step's draws, regenerated in its order
    k_rays, k_core = jax.random.split(jax.random.fold_in(KEY, 0))
    rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W,
                                           cfg_j.num_rays))(
        k_rays, jnp.asarray(pose))
    k_bg, k_perturb = jax.random.split(k_core)
    draws = dict(o=np.asarray(rays["rays_o"][0]),
                 d=np.asarray(rays["rays_d"][0]),
                 bg=np.asarray(jax.random.uniform(k_bg, (cfg_j.num_rays, 3))),
                 u=np.asarray(jax.random.uniform(k_perturb,
                                                 (cfg_j.num_rays,))),
                 k_perturb=k_perturb)
    return dict(cfg_j=cfg_j, rspec_j=rspec_j, spec_tj=spec_tj,
                spec_sj=spec_sj, tea_kw=tea_kw, tea=tea, stu=stu,
                occ_j=occ_j, pose=pose, draws=draws)


@pytest.fixture(scope="module")
def setup():
    return _build(TEA_KW)


@pytest.fixture(scope="module")
def cell_setup():
    return _build(CELL_TEA_KW)


def _jax_grads(s, stage, spr=CFG_KW["samples_per_ray"]):
    """JAX distill_loss under value_and_grad, step 0, computed once per
    (stage, samples_per_ray); samples_per_ray 0 is the padded path."""
    cache = s.setdefault("jax_grads", {})
    if (stage, spr) in cache:
        return cache[stage, spr]
    tea = jax.tree_util.tree_map(jnp.asarray, s["tea"])
    dr = s["draws"]
    rspec = dataclasses.replace(s["rspec_j"], samples_per_ray=spr)

    def f(p):
        return j_distill_loss(
            p, tea, s["spec_sj"], s["spec_tj"], rspec, s["cfg_j"],
            stage, s["occ_j"], s["occ_j"], jnp.asarray(dr["o"]),
            jnp.asarray(dr["d"]), jnp.asarray(dr["bg"]), dr["k_perturb"],
            jnp.int32(0))

    (loss, (logs, _)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, s["stu"]))
    cache[stage, spr] = (float(loss),
                         jax.tree_util.tree_map(np.asarray, logs),
                         jax.tree_util.tree_map(np.asarray, grads))
    return cache[stage, spr]


@pytest.fixture(scope="module")
def jax_stages(setup):
    return lambda *a: _jax_grads(setup, *a)


def _port(setup):
    s = setup
    cfg = PVDConfig(**CFG_KW)
    teacher = hash_field_from_jax(s["tea"], ModelSpec(**s["tea_kw"]), "cpu")
    student = vm_field_from_jax(s["stu"], ModelSpec(**STU_KW), "cpu")
    occ = occupancy_from_jax(s["occ_j"], "cpu")
    dr = {k: torch.from_numpy(np.array(v)) for k, v in s["draws"].items()
          if k != "k_perturb"}
    return cfg, teacher, student, occ, dr


def _assert_grads(student, want):
    got = vm_tree_from_field(student, grad=True)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_REL_ATOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("stage,spr", [(1, 8.0), (2, 8.0), (3, 8.0),
                                       (1, 0.0), (3, 0.0)],
                         ids=["stage1", "stage2", "stage3", "padded-stage1",
                              "padded-stage3"])
def test_distill_loss_matches_jax(setup, jax_stages, stage, spr):
    """Stages 1-3 on the compacted path (samples_per_ray 8), and the
    padded [N, S] path (samples_per_ray 0) at stages 1 and 3."""
    cfg, teacher, student, occ, dr = _port(setup)
    rspec = dataclasses.replace(cfg.render_spec(), samples_per_ray=spr)
    loss, (logs, _) = distill_loss(
        student, teacher, ModelSpec(**STU_KW), ModelSpec(**TEA_KW), rspec,
        cfg, stage, occ, occ, dr["o"], dr["d"], dr["bg"], dr["u"], 0)
    loss.backward()
    want_loss, want_logs, want_grads = jax_stages(stage, spr)
    keys = {"loss", "loss_fea_sc", "budget_hit", "mask_frac"}
    keys |= {"compact_frac"} if spr else set()
    keys |= {"loss_sigma", "loss_color"} if stage >= 2 else set()
    keys |= {"loss_rgb", "psnr"} if stage == 3 else set()
    assert set(logs) == set(want_logs) == keys
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    for k in keys:
        np.testing.assert_allclose(logs[k].item(), float(want_logs[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    # the batch is a real one: ~6 of 32 slots per ray filled, and the
    # compacted path stays under its budget
    assert float(want_logs["mask_frac"]) > 0.1
    if spr:
        assert 0.3 < float(want_logs["compact_frac"]) < 1.0
    _assert_grads(student, want_grads)
    if stage == 1:  # no color work at stage 1
        assert all(lin.weight.grad is None for lin in student.color_net)


def _check_whole_step(s):
    """One jitted JAX make_distill_step at stage 3 against the port's
    distill_step_core on the regenerated draws."""
    stu_tree = jax.tree_util.tree_map(jnp.asarray, s["stu"])
    j_opt = j_optim.build_optimizer(
        stu_tree, j_label(s["spec_sj"]), j_trainable(s["spec_sj"], ""),
        j_optim.cosine_schedule(1e-2, ITERS),
        j_optim.cosine_schedule(1e-3, ITERS))
    j_state = JTrainState(params=stu_tree, opt_state=j_opt.init(stu_tree),
                          occ=s["occ_j"], step=jnp.int32(0))
    j_step = j_make_step(s["spec_sj"], s["spec_tj"], s["rspec_j"], j_opt,
                         s["cfg_j"], INTR, H, W, stage=3)
    j_new, j_logs = j_step(j_state, jax.tree_util.tree_map(jnp.asarray,
                                                           s["tea"]),
                           s["occ_j"], jnp.asarray(s["pose"]), KEY)

    cfg, teacher, student, occ, dr = _port(s)
    spec_s = ModelSpec(**STU_KW)
    params = dict(student.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec_s), trainable_label(spec_s, ""),
        optim.cosine_schedule(1e-2, ITERS), optim.cosine_schedule(1e-3,
                                                                  ITERS))
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    step = make_distill_step(spec_s, ModelSpec(**s["tea_kw"]),
                             cfg.render_spec(), opt, cfg, INTR, H, W,
                             stage=3, device="cpu")
    state, logs = step.core(state, teacher, occ, dr["o"], dr["d"], dr["bg"],
                            dr["u"])
    assert state.step == 1 and int(j_new.step) == 1
    np.testing.assert_allclose(logs["loss"].item(), float(j_logs["loss"]),
                               rtol=LOSS_RTOL)
    for k in j_logs:
        np.testing.assert_allclose(logs[k].item(), float(j_logs[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _assert_grads(student, _jax_grads(s, 3)[2])
    got = vm_tree_from_field(student)
    g_want = jax.tree_util.tree_leaves(_jax_grads(s, 3)[2])
    n_held = 0
    for (path, w), g, gw in zip(
            jax.tree_util.tree_flatten_with_path(j_new.params)[0],
            jax.tree_util.tree_leaves(got), g_want):
        hold = (np.abs(gw) > MASK_FRAC * np.abs(gw).max()) | (gw == 0)
        np.testing.assert_allclose(g[hold], np.asarray(w)[hold], rtol=0,
                                   atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        n_held += int(hold.sum())
    assert n_held > 0.9 * sum(np.size(x) for x in g_want)


def test_whole_step_matches_jax(setup):
    _check_whole_step(setup)


def test_cell_teacher_whole_step_matches_jax(cell_setup):
    """The same step with a cell-mode teacher: its replay reads both of its
    tables, the cell levels through the cell encode."""
    assert "encoder_cell" in cell_setup["tea"]
    _check_whole_step(cell_setup)


@pytest.mark.parametrize("loss_type", ["L2", "normL2", "normL1", "smoothL1"])
def test_losses_match_jax(loss_type):
    """masked_loss (mask broadcast over channels) and rgb_loss."""
    rng = np.random.default_rng(5)
    pred, gt = (rng.normal(scale=0.1, size=(64, 16)).astype(np.float32)
                for _ in range(2))
    mask = rng.uniform(size=64) < 0.6
    got = masked_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                      torch.from_numpy(mask), loss_type)
    want = j_masked_loss(jnp.asarray(pred), jnp.asarray(gt),
                         jnp.asarray(mask), loss_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    got = rgb_loss(torch.from_numpy(pred), torch.from_numpy(gt), loss_type)
    want = j_rgb_loss(jnp.asarray(pred), jnp.asarray(gt), loss_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
