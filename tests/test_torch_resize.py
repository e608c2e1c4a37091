"""pvd_tpu_torch's VM and plenoxel resizing against the JAX package (CPU).

The resize functions on random tables at a non-cubic size (VM (20, 24,
28), ranks 4 and 12; a 6 x 7 x 8 x 28 plenoxel volume), then the
Trainer's scheduled resize (`_maybe_vm_resize`) of both packages on the
same VM field and the same occupancy grid (grid 32, a box of dense cells
inside the unit cube): a teacher-mode resize, its checkpoint written by
the JAX package and loaded by the port's distill Trainer, and a distill
resize of a VM student inside the teacher's grid, followed by the next
step's loss and gradients on the same rays.

Tolerances:
  * resized tables: 1e-6 of the leaf's max |value| (the JAX package sums
    in float64 and rounds once, the port in float32: measured ~2e-7);
    the crop bounds, the per-axis resolutions and the new aabb exactly;
  * the next distill step: the loss rtol 2e-5, the gradients atol 2e-5
    of the leaf's max |g| plus rtol 1e-4, as tests/test_torch_distill.py
    holds a step;
  * eval images of the same field by both packages: 1e-4 absolute (the
    same samples, f32 heads summed in other orders).

Witnesses of the JAX package's own behavior, which the port reproduces:
  * C9: a shrink moves only `aabb_train`, while `evaluate` renders with
    `aabb_infer` (the whole bound), so the shrunk field's tables are read
    as if they spanned the bound: the eval image after the resize moves
    far from the one before it, where normalizing by `aabb_train` keeps
    it close;
  * C10: the resize leaves the EMA weights at the old shapes, and the
    JAX Trainer's next step raises; the port refuses EMA together with
    resizing of a VM or plenoxel field;
  * C11: after a shrink the field reads density exp(0) = 1 everywhere
    outside the new box (its tables' zero padding), so occupancy cells
    there can turn occupied; a later shrink then takes a box larger than
    the tables span, crops nothing and stretches the tables over it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.cli import common as j_common
from pvd_tpu.config import ModelSpec as JModelSpec
from pvd_tpu.config import PVDConfig as JPVDConfig
from pvd_tpu.data.synth import make_synthetic_scene as j_make_scene
from pvd_tpu.data.provider import NeRFDataset as JNeRFDataset
from pvd_tpu.engine.train_steps import distill_loss as j_distill_loss
from pvd_tpu.engine.trainer import Trainer as JTrainer
from pvd_tpu.models.api import field_density as j_field_density
from pvd_tpu.models import tensors_field as j_tensors
from pvd_tpu.models import vm_field as j_vm
from pvd_tpu.render import init_occupancy_state as j_init_occ
from pvd_tpu.render.occupancy import set_bitfield as j_set_bitfield
from pvd_tpu_torch.cli.common import upsample_schedule
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.poses import pose_spherical
from pvd_tpu_torch.engine.train_steps import distill_loss
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import field_density
from pvd_tpu_torch.models import tensors_field, vm_field
from pvd_tpu_torch.ops.rays import get_rays, nerf_matrix_to_ngp
from pvd_tpu_torch.params import (occupancy_from_jax, tensors_field_from_jax,
                                  vm_field_from_jax, vm_tree_from_field)

torch.set_num_threads(1)

TABLE_RTOL = 1e-6
LOSS_RTOL, GRAD_REL_ATOL, GRAD_RTOL = 2e-5, 2e-5, 1e-4
IMAGE_ATOL = 1e-4
KEYS = ("sigma_mat", "sigma_vec", "color_mat", "color_vec")
SMALL_VM = dict(model_type="vm", vm_sigma_rank=4, vm_color_rank=12,
                vm_resolution=(20, 24, 28), compute_dtype="float32")
CFG = dict(num_rays=256, grid_size=32, max_steps=128, max_samples=32,
           samples_per_ray=0.0, autotune_budget=False, precision="fp32",
           model_type="vm", resolution0=24, resolution1=32,
           upsample_model_steps=(5,), iters=100)
RES_STEP = 5
# the dense cells of the teacher's grid, and those of the grid its
# checkpoint carries into distillation (inside the first box)
BOX1 = ((10, 22), (12, 24), (8, 18))
BOX2 = ((12, 20), (14, 22), (10, 16))
SPR = 8.0  # the distill step's budget
H_IMG = W_IMG = 24
INTR = (20.0, 20.0, 12.0, 12.0)


def _random_vm_tree(spec_kw, seed, scale=0.1):
    spec = JModelSpec(**spec_kw)
    return jax.tree_util.tree_map(
        np.asarray, j_vm.init(jax.random.PRNGKey(seed), spec, scale))


def _smooth_vm_tree(res, seed):
    """A VM tree at `res` whose tables vary smoothly (a 4 x 5 x 6 one
    resized), so that a shift of a voxel changes the field little; the
    rest of the JAX init."""
    kw = dict(model_type="vm", compute_dtype="float32")
    coarse = _random_vm_tree(dict(kw, vm_resolution=(4, 5, 6)), seed, 0.7)
    tree = j_vm.upsample_params(coarse, res)
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tables(got, want):
    for k in KEYS:
        for i in range(3):
            w = np.asarray(want[k][i])
            assert got[k][i].shape == w.shape, (k, i)
            np.testing.assert_allclose(got[k][i], w, rtol=0,
                                       atol=TABLE_RTOL * np.abs(w).max(),
                                       err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("res", [(36, 40, 44), (11, 13, 7), (20, 1, 28)],
                         ids=["up", "down", "one-row"])
def test_vm_upsample_matches_jax(res):
    tree = _random_vm_tree(SMALL_VM, 1)
    field = vm_field_from_jax(tree, ModelSpec(**SMALL_VM), "cpu")
    vm_field.upsample_params(field, res)
    assert field.spec.vm_resolution == res
    assert all(p.is_contiguous() for p in field.parameters())
    _assert_tables(vm_tree_from_field(field), j_vm.upsample_params(tree, res))


@pytest.mark.parametrize("new_aabb", [
    (-0.5, -0.3, -0.8, 0.6, 0.7, 0.2), (-1.2, -1.0, 0.9, 1.3, 0.1, 1.0),
    (0.01, 0.02, 0.03, 0.04, 0.05, 0.06)], ids=["inside", "past", "thin"])
def test_vm_shrink_matches_jax(new_aabb):
    """The crop bounds exactly, the tables exactly (a crop), on a
    non-cubic aabb."""
    tree = _random_vm_tree(SMALL_VM, 2)
    aabb = np.array([-1.0, -0.8, -1.2, 1.0, 0.8, 1.2], np.float32)
    new_aabb = np.asarray(new_aabb)
    field = vm_field_from_jax(tree, ModelSpec(**SMALL_VM), "cpu")
    tl, br = vm_field.shrink_params(field, aabb, new_aabb, (20, 24, 28))
    want, tl_j, br_j = j_vm.shrink_params(tree, aabb, new_aabb, (20, 24, 28))
    np.testing.assert_array_equal(tl, tl_j)
    np.testing.assert_array_equal(br, br_j)
    assert field.spec.vm_resolution == tuple(int(v) for v in br - tl)
    got = vm_tree_from_field(field)
    for k in KEYS:
        for i in range(3):
            np.testing.assert_array_equal(got[k][i], np.asarray(want[k][i]))


@pytest.mark.parametrize("res", [(9, 10, 11), (3, 7, 5)], ids=["up", "down"])
def test_plenoxel_upsample_matches_jax(res):
    vol = np.random.default_rng(3).normal(size=(6, 7, 8, 28)) \
        .astype(np.float32)
    spec = ModelSpec(model_type="tensors", plenoxel_res=(6, 7, 8),
                     compute_dtype="float32")
    field = tensors_field_from_jax({"volume": vol}, spec, "cpu")
    tensors_field.upsample_params(field, res)
    want = np.asarray(j_tensors.upsample_params({"volume": vol},
                                                res)["volume"])
    got = field.volume.detach().numpy()
    assert got.shape == want.shape and field.spec.plenoxel_res == res
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TABLE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(resolution0=128, resolution1=300, upsample_model_steps=(200, 300,
                                                                 400, 550,
                                                                 700)),
    dict(resolution0=64, resolution1=128, upsample_model_steps=(400, 800)),
    dict(resolution0=300, resolution1=300, upsample_model_steps=())],
    ids=["vm", "plenoxel", "none"])
def test_upsample_schedule_matches_jax(kw):
    got = upsample_schedule(PVDConfig(**kw))
    assert got == j_common.upsample_schedule(JPVDConfig(**kw))
    assert len(got) == len(kw["upsample_model_steps"])


def _grid_occ(rspec_j, box, mean=4.0):
    """The JAX package's occupancy state with cells of density 20 in `box`
    (per-axis index ranges), 0.5 elsewhere, and their bits set."""
    H = rspec_j.grid_size
    grid = np.full((1, H, H, H), 0.5, np.float32)
    (a0, a1), (b0, b1), (c0, c1) = box
    grid[0, a0:a1, b0:b1, c0:c1] = 20.0
    occ = j_init_occ(rspec_j).replace(
        density_grid=jnp.asarray(grid), mean_density=jnp.float32(mean),
        iter_density=jnp.int32(20))
    return j_set_bitfield(occ, jnp.asarray(grid.reshape(-1) > mean))


def _eval_images(j_tr, p_tr, pose):
    """The trained field's eval image of `pose` by each package."""
    img_j, _ = j_tr._eval_render(j_tr.state.params, j_tr.state.occ, pose,
                                 INTR, H_IMG, W_IMG)
    img_p = p_tr.eval_render(p_tr.state.field, p_tr.state.occ, pose, INTR,
                             H_IMG, W_IMG).image.numpy()
    return np.asarray(img_j), img_p


def _psnr(a, b):
    return float(-10.0 * np.log10(np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A VM teacher of each package with the same smooth 24^3 tables on
    the same grid (dense cells in BOX1): eval images before and after the
    scheduled resize at step 5 (shrink to the box, then equal-volume
    voxels at 32), and a checkpoint of the JAX one after it, whose grid's
    dense cells are BOX2."""
    ws = tmp_path_factory.mktemp("teacher")
    j_tr = JTrainer(JPVDConfig(**CFG, workspace=str(ws / "jax")))
    p_tr = Trainer(PVDConfig(**CFG, workspace=str(ws / "torch")),
                   device="cpu")
    tree = _smooth_vm_tree((24, 24, 24), 5)
    occ_j = _grid_occ(j_tr.rspec, BOX1)
    j_tr.state = j_tr.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree), occ=occ_j)
    p_tr.state.field = vm_field_from_jax(tree, p_tr.spec_stu, "cpu")
    p_tr.state.occ = occupancy_from_jax(occ_j, "cpu")
    j_tr.upsample_resolutions = j_common.upsample_schedule(j_tr.cfg)
    p_tr.upsample_resolutions = upsample_schedule(p_tr.cfg)
    pose = nerf_matrix_to_ngp(pose_spherical(30.0, -30.0, 4.0), scale=0.8)
    before = _eval_images(j_tr, p_tr, pose)
    for tr in (j_tr, p_tr):
        tr._maybe_vm_resize(RES_STEP - 1)  # not a scheduled step
        tr._maybe_vm_resize(RES_STEP)
    after = _eval_images(j_tr, p_tr, pose)
    # the port's field rendered with aabb_infer = aabb_train
    occ = p_tr.state.occ
    ref = p_tr.eval_render(p_tr.state.field, occ.replace(
        aabb_infer=occ.aabb_train), pose, INTR, H_IMG, W_IMG).image.numpy()
    j_tr.state = j_tr.state.replace(occ=_grid_occ(j_tr.rspec, BOX2).replace(
        aabb_train=j_tr.state.occ.aabb_train))
    path = j_tr.save()
    return dict(j_tr=j_tr, p_tr=p_tr, before=before, after=after, ref=ref,
                path=path, ws=ws)


def test_trainer_resize_matches_jax(teacher):
    """The teacher-mode resize: tables, per-axis resolution (non-cubic)
    and the new aabb_train; the optimizer state starts afresh."""
    j_tr, p_tr = teacher["j_tr"], teacher["p_tr"]
    res = tuple(j_tr.vm_resolution)
    assert p_tr.spec_stu.vm_resolution == res == \
        p_tr.state.field.spec.vm_resolution
    assert len(set(res)) > 1 and res != (24, 24, 24)
    np.testing.assert_array_equal(p_tr.state.occ.aabb_train.numpy(),
                                  np.asarray(j_tr.state.occ.aabb_train))
    _assert_tables(vm_tree_from_field(p_tr.state.field), j_tr.state.params)
    assert p_tr.state.opt_state.count == 0
    for name, p in p_tr.state.field.named_parameters():
        assert p_tr.state.opt_state.mu[name].shape == p.shape, name


def test_eval_after_a_shrink_matches_jax(teacher):
    """C9: both packages render the same image before and after the
    resize; after it their image is far from the one before, while the
    same field read over aabb_train stays close to it."""
    (bj, bp), (aj, ap) = teacher["before"], teacher["after"]
    np.testing.assert_allclose(bp, bj, atol=IMAGE_ATOL)
    np.testing.assert_allclose(ap, aj, atol=IMAGE_ATOL)
    moved, kept = _psnr(aj, bj), _psnr(teacher["ref"], bj)
    print(f"C9: eval PSNR after the resize against before: {moved:.2f} dB "
          f"(JAX), {_psnr(ap, bp):.2f} dB (port); over aabb_train "
          f"{kept:.2f} dB")
    assert kept > moved + 10.0, (moved, kept)


@pytest.fixture(scope="module")
def distill(teacher):
    """Both packages' distill Trainers load the resized teacher's JAX
    checkpoint, take the same smooth VM student, and resize it at step 5
    inside the teacher's grid."""
    cfg = dict(CFG, teacher_type="vm")
    ws = teacher["ws"]
    j_tr = JTrainer(JPVDConfig(**cfg, workspace=str(ws / "jax_d")),
                    mode="distill")
    p_tr = Trainer(PVDConfig(**cfg, workspace=str(ws / "torch_d")),
                   mode="distill", device="cpu")
    for tr in (j_tr, p_tr):
        tr.load_teacher(teacher["path"])
    shared = p_tr.state.occ is p_tr.occ_tea
    tree = _smooth_vm_tree((24, 24, 24), 6)
    j_tr.state = j_tr.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree))
    p_tr.state.field = vm_field_from_jax(tree, p_tr.spec_stu, "cpu")
    j_tr.upsample_resolutions = j_common.upsample_schedule(j_tr.cfg)
    p_tr.upsample_resolutions = upsample_schedule(p_tr.cfg)
    for tr in (j_tr, p_tr):
        tr._maybe_vm_resize(RES_STEP)
    return dict(j_tr=j_tr, p_tr=p_tr, shared=shared)


def test_resized_teacher_loads_from_jax(teacher, distill):
    """The port's load_teacher takes the resized (non-cubic) shapes from
    the checkpoint's leaves."""
    j_tr, p_tr = distill["j_tr"], distill["p_tr"]
    res = tuple(teacher["j_tr"].vm_resolution)
    assert p_tr.spec_tea.vm_resolution == res == p_tr.teacher.spec \
        .vm_resolution
    got = vm_tree_from_field(p_tr.teacher)
    for k in KEYS:
        for i in range(3):
            np.testing.assert_array_equal(got[k][i],
                                          np.asarray(j_tr.params_tea[k][i]))


def test_distill_resize_matches_jax_and_keeps_the_teacher_grid(distill):
    """The student's resize inside the teacher's grid: the same tables,
    resolution and aabb_train as JAX's; the teacher's grid, which the
    student's state held until then, keeps its own aabb_train."""
    j_tr, p_tr = distill["j_tr"], distill["p_tr"]
    assert distill["shared"]
    assert p_tr.spec_stu.vm_resolution == tuple(j_tr.vm_resolution)
    np.testing.assert_array_equal(p_tr.state.occ.aabb_train.numpy(),
                                  np.asarray(j_tr.state.occ.aabb_train))
    np.testing.assert_array_equal(p_tr.occ_tea.aabb_train.numpy(),
                                  np.asarray(j_tr.occ_tea.aabb_train))
    assert not np.array_equal(p_tr.occ_tea.aabb_train.numpy(),
                              p_tr.state.occ.aabb_train.numpy())
    assert (p_tr.occ_tea.aabb_train.data_ptr()
            != p_tr.state.occ.aabb_train.data_ptr())
    _assert_tables(vm_tree_from_field(p_tr.state.field), j_tr.state.params)


def test_step_after_the_resize_matches_jax(distill):
    """The next stage-3 distill step's loss, logs and student gradients
    on the same rays, the resized student against the resized teacher,
    on the compacted path (8 samples per ray)."""
    j_tr, p_tr = distill["j_tr"], distill["p_tr"]
    rng = np.random.default_rng(8)
    pose = nerf_matrix_to_ngp(pose_spherical(70.0, -40.0, 4.0), scale=0.8)
    # pixels of the image's central quarter, where the grid's box lies
    inds = torch.from_numpy(rng.integers(12, 36, 256) * 48
                            + rng.integers(12, 36, 256))
    rays = get_rays(torch.from_numpy(pose)[None], (40.0, 40.0, 24.0, 24.0),
                    48, 48, inds)
    o, d = rays["rays_o"][0].contiguous(), rays["rays_d"][0].contiguous()
    bg = torch.from_numpy(rng.uniform(size=(256, 3)).astype(np.float32))
    key = jax.random.PRNGKey(9)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (256,))))
    rspec_j = dataclasses.replace(j_tr.rspec, samples_per_ray=SPR)

    def f(p):
        return j_distill_loss(
            p, j_tr.params_tea, j_tr.spec_stu, j_tr.spec_tea, rspec_j,
            j_tr.cfg, 3, j_tr.state.occ, j_tr.occ_tea, jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(bg), key, jnp.int32(0))

    (loss_j, (logs_j, _)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(j_tr.state.params)
    field = p_tr.state.field
    loss, (logs, _) = distill_loss(
        field, p_tr.teacher, p_tr.spec_stu, p_tr.spec_tea,
        dataclasses.replace(p_tr.rspec, samples_per_ray=SPR), p_tr.cfg, 3,
        p_tr.state.occ, p_tr.occ_tea, o, d, bg, u, 0)
    loss.backward()
    assert float(logs_j["mask_frac"]) > 0.02  # ~380 samples
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    for k in logs_j:
        np.testing.assert_allclose(float(logs[k].detach()),
                                   float(logs_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = vm_tree_from_field(field, grad=True)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(grads)[0],
                            jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_REL_ATOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_c2f_plenoxel_student_loads_from_jax(tmp_path):
    """A plenoxel field started at resolution0^3 and upsampled by the
    Trainer of each package; the JAX checkpoint of the upsampled volume
    loads into a port Trainer whose config names only resolution0."""
    cfg = dict(CFG, model_type="tensors", resolution0=6, resolution1=9,
               upsample_model_steps=(3,))
    j_tr = JTrainer(JPVDConfig(**cfg, workspace=str(tmp_path / "jax")))
    p_tr = Trainer(PVDConfig(**cfg, workspace=str(tmp_path / "torch")),
                   device="cpu")
    assert p_tr.spec_stu.plenoxel_res == (6, 6, 6)
    vol = np.random.default_rng(4).normal(size=(6, 6, 6, 28)) \
        .astype(np.float32)
    j_tr.state = j_tr.state.replace(params={"volume": jnp.asarray(vol)})
    p_tr.state.field = tensors_field_from_jax({"volume": vol},
                                              p_tr.spec_stu, "cpu")
    j_tr.upsample_resolutions = j_common.upsample_schedule(j_tr.cfg)
    p_tr.upsample_resolutions = upsample_schedule(p_tr.cfg)
    for tr in (j_tr, p_tr):
        tr._maybe_vm_resize(3)
    want = np.asarray(j_tr.state.params["volume"])
    assert want.shape == (9, 9, 9, 28)
    np.testing.assert_allclose(p_tr.state.field.volume.detach().numpy(),
                               want, rtol=0,
                               atol=TABLE_RTOL * np.abs(want).max())
    path = j_tr.save()
    again = Trainer(PVDConfig(**cfg, workspace=str(tmp_path / "again")),
                    device="cpu")
    again.load_student(path)
    assert again.spec_stu.plenoxel_res == (9, 9, 9)
    np.testing.assert_array_equal(again.state.field.volume.detach().numpy(),
                                  want)


def test_ema_with_resizing_raises_in_jax_and_is_refused(tmp_path):
    """C10: the JAX Trainer's first step after a VM resize with EMA on
    raises (its EMA weights keep the old shapes); the port refuses the
    combination up front, for a VM and for a plenoxel field."""
    root = j_make_scene(str(tmp_path / "scene"), n_train=2, n_val=0,
                        n_test=0, H=16, W=16)
    cfg = dict(CFG, num_rays=64, ema_decay=0.9, upsample_model_steps=(1,),
               iters=3, eval_interval=10 ** 6)
    jcfg = JPVDConfig(**cfg, path=root, workspace=str(tmp_path / "jax"))
    j_tr = JTrainer(jcfg)
    j_tr.upsample_resolutions = j_common.upsample_schedule(jcfg)
    with pytest.raises((TypeError, ValueError), match="shapes"):
        j_tr.train(JNeRFDataset(jcfg, "train"))
    assert tuple(j_tr.vm_resolution) != (24, 24, 24)
    for model_type in ("vm", "tensors"):
        with pytest.raises(NotImplementedError, match="ROADMAP C10"):
            Trainer(PVDConfig(**dict(cfg, model_type=model_type)),
                    device="cpu")
    # EMA alone and resizing alone are taken
    Trainer(PVDConfig(**dict(cfg, upsample_model_steps=())), device="cpu")
    Trainer(PVDConfig(**dict(cfg, ema_decay=-1.0)), device="cpu")


def test_later_shrink_can_grow_the_box(teacher):
    """C11, on the teacher of the resize above (run after the tests that
    read its state): outside its shrunk box the field's density is
    exp(0) = 1 in both packages; with those cells occupied (a grid of the
    first box plus a slab past it, mean density 0.5), the next scheduled
    shrink takes a larger box, crops nothing (the same shape) and moves
    aabb_train to it, the same in both packages."""
    j_tr, p_tr = teacher["j_tr"], teacher["p_tr"]
    old = p_tr.state.occ.aabb_train.numpy().copy()
    x = np.array([[0.9, 0.9, 0.9], [-0.95, 0.8, 0.95]], np.float32)
    assert ((x < old[:3]) | (x > old[3:])).any(axis=1).all()
    want = np.asarray(j_field_density(j_tr.state.params, j_tr.spec_stu,
                                      jnp.asarray(x),
                                      j_tr.state.occ.aabb_train))
    with torch.no_grad():
        got = field_density(p_tr.state.field, p_tr.spec_stu,
                            torch.from_numpy(x), p_tr.state.occ.aabb_train)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.ones(2, np.float32))
    box = ((BOX1[0][0], 30), BOX1[1], BOX1[2])  # the slab past the box
    occ_j = _grid_occ(j_tr.rspec, box, mean=0.5).replace(
        aabb_train=j_tr.state.occ.aabb_train)
    j_tr.state = j_tr.state.replace(occ=occ_j)
    p_tr.state.occ = occupancy_from_jax(occ_j, "cpu")
    res = tuple(j_tr.vm_resolution)
    for tr in (j_tr, p_tr):
        tr.upsample_steps.append(RES_STEP + 1)
        tr._maybe_vm_resize(RES_STEP + 1)  # no scheduled resolution: shrink
    new = p_tr.state.occ.aabb_train.numpy()
    np.testing.assert_array_equal(new, np.asarray(j_tr.state.occ.aabb_train))
    assert new[3] > old[3] + 0.3 and tuple(j_tr.vm_resolution) == res
    assert p_tr.spec_stu.vm_resolution == res
    _assert_tables(vm_tree_from_field(p_tr.state.field), j_tr.state.params)
