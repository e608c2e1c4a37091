"""pvd_tpu_torch's error map and EMA against the JAX package (CPU).

The error map: the host draw (numpy in both packages) bit for bit; the
device draw's map from cells and jitters to pixels against the JAX
package's jitted get_rays on its own cells and jitters; the preload
teacher step, the host-batcher teacher step and the stage-3 distill step
of each package on the same rays (the JAX step's draws regenerated from
its key in its order), at the sizes of tests/test_torch_teacher.py and
tests/test_torch_distill.py; then the Trainer's map in each flavor.
EMA: the update rule after N steps against the JAX package's ema_update,
its re-seed at load_teacher, its restore at load_student (from a JAX
checkpoint, and from one without EMA weights), the best checkpoint and
evaluate.

Tolerances:
  * per-ray losses and loss: rtol 2e-5 (as the steps' losses);
  * the updated map row (`chip_smoke.check_emap_row`, which the card's
    check uses too): the cells drawn once, rtol 2e-5 plus 2e-5 of the
    row's max; a cell drawn by several rays holds one of their values
    (0.1 x old + 0.9 x that ray's loss) in each package, which one being
    unspecified (`error_map_update`);
  * EMA weights: 1e-6 of the leaf's max |value| against the JAX rule on
    the same trajectory; restored weights exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.engine import checkpoint as j_ckpt
from pvd_tpu.engine import optim as j_optim
from pvd_tpu.engine.train_steps import TrainState as JTrainState
from pvd_tpu.engine.train_steps import make_distill_step as j_make_distill
from pvd_tpu.engine.train_steps import make_teacher_step as j_make_teacher
from pvd_tpu.engine.train_steps import \
    make_teacher_step_host as j_make_host
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import draw_error_map_inds_np as j_draw_np
from pvd_tpu.ops.rays import get_rays as j_get_rays
from chip_smoke import check_emap_row
from pvd_tpu_torch.config import ModelSpec, PVDConfig
from pvd_tpu_torch.data.synth import make_synthetic_scene
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine import optim
from pvd_tpu_torch.engine import trainer as trainer_mod
from pvd_tpu_torch.engine.train_steps import (TrainState, make_distill_step,
                                              make_teacher_step,
                                              make_teacher_step_host)
from pvd_tpu_torch.engine.trainer import Trainer
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.ops.rays import (ERROR_MAP_CELLS, draw_error_map_inds_np,
                                    draw_error_map_pixels, error_map_pixels,
                                    get_rays)
from pvd_tpu_torch.params import (hash_field_from_jax, occupancy_from_jax,
                                  tree_from_field, vm_field_from_jax)
from test_torch_distill import STU_KW, TEA_KW
from test_torch_distill import _build as build_distill
from test_torch_teacher import H, INTR, ITERS, SPEC_KW, W
from test_torch_teacher import _build as build_teacher

torch.set_num_threads(1)

RTOL = 2e-5
EMA_RTOL = 1e-6
DECAY = 0.9
KEY = jax.random.PRNGKey(11)
# the teacher's rows: random weights on every cell ("spread": a few cells
# drawn twice) or on 300 cells only ("peaked": many cells drawn twice)
ROWS = ("spread", "peaked")
# port Trainer runs: a small VM field on the in-memory scene
SCENE = dict(n_train=4, n_val=1, n_test=1, H=24, W=24)
TRAINER_CFG = dict(model_type="vm", resolution0=16, num_rays=64,
                   grid_size=16, max_steps=64, max_samples=16,
                   samples_per_ray=0.0, autotune_budget=False,
                   precision="fp32", iters=6, eval_interval=10 ** 6)


def _row(kind, seed=0):
    rng = np.random.default_rng(seed)
    row = rng.uniform(0.05, 1.0, ERROR_MAP_CELLS).astype(np.float32)
    if kind == "peaked":
        keep = np.zeros(ERROR_MAP_CELLS, bool)
        keep[rng.choice(ERROR_MAP_CELLS, 300, replace=False)] = True
        row[~keep] = 0.0
    return row


@pytest.mark.parametrize("H_,W_,n", [(48, 48, 256), (96, 96, 4096),
                                     (37, 129, 1000)])
def test_host_draw_equals_jax(H_, W_, n):
    row = _row("peaked")
    got = draw_error_map_inds_np(np.random.default_rng(3), row, H_, W_, n)
    want = j_draw_np(np.random.default_rng(3), row, H_, W_, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("H_,W_", [(48, 48), (40, 56), (800, 800),
                                   (37, 129)])
def test_device_draw_maps_cells_to_jax_pixels(H_, W_):
    """The JAX package's jitted draw, its cells and jitters regenerated
    from its key, gives the pixels error_map_pixels gives them."""
    n = min(4096, H_ * W_)
    row = _row("spread")[None]
    key = jax.random.PRNGKey(3)
    out = jax.jit(lambda k, e: j_get_rays(
        k, np.eye(4, dtype=np.float32)[None], (40.0, 40.0, H_ / 2, W_ / 2),
        H_, W_, n, error_map=e))(key, jnp.asarray(row))
    _, k_jx, k_jy = jax.random.split(key, 3)
    jx = np.asarray(jax.random.uniform(k_jx, (1, n)))[0]
    jy = np.asarray(jax.random.uniform(k_jy, (1, n)))[0]
    cells = torch.from_numpy(np.asarray(out["inds_coarse"][0], np.int64))
    got = error_map_pixels(cells, torch.from_numpy(jx), torch.from_numpy(jy),
                           H_, W_)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out["inds"][0]))


def test_device_draw_follows_the_map():
    """Cells only where the map has weight, at rates proportional to it
    (200,000 draws: within 0.01 of each rate); pixels inside their cell."""
    row = torch.zeros(ERROR_MAP_CELLS)
    cells_w = {5: 1.0, 700: 2.0, 9000: 3.0, 16383: 4.0}
    for c, w in cells_w.items():
        row[c] = w
    gen = torch.Generator().manual_seed(0)
    inds, cells = draw_error_map_pixels(gen, row, 200_000, 512, 512)
    assert set(cells.unique().tolist()) <= set(cells_w)
    for c, w in cells_w.items():
        assert abs(float((cells == c).float().mean()) - w / 10.0) < 0.01
    rows, cols = inds // 512, inds % 512
    assert torch.equal(rows // 4, cells // 128)
    assert torch.equal(cols // 4, cells % 128)
    inds, _ = draw_error_map_pixels(gen, row, 10_000, 8, 8)
    assert inds.shape == (64,)  # min(n_rays, H * W), as get_rays draws


def _check_row(got, want, old, cells, per_ray):
    """chip_smoke.check_emap_row at RTOL: the rows agree; returns (cells
    drawn once, cells drawn several times)."""
    r = check_emap_row(got, want, old, np.asarray(cells),
                       np.asarray(per_ray), RTOL)
    assert r["ok"], r
    return r["cells_once"], r["cells_repeated"]


def _teacher_port(s, use_error_map, host=False):
    cfg = PVDConfig(num_rays=256, grid_size=32, max_steps=128,
                    max_samples=32, samples_per_ray=16.0, precision="fp32",
                    ema_decay=DECAY)
    spec = ModelSpec(**SPEC_KW)
    field = hash_field_from_jax(s["tree"], spec, "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.exp_decay_schedule(1e-2, ITERS),
        optim.exp_decay_schedule(1e-3, ITERS))
    ema = hash_field_from_jax(s["tree"], spec, "cpu").requires_grad_(False)
    state = TrainState(field=field, opt_state=opt.init(params),
                       occ=occupancy_from_jax(s["occ_j"], "cpu"), ema=ema)
    make = make_teacher_step_host if host else make_teacher_step
    step = make(spec, cfg.render_spec(), opt, cfg, INTR, H, W,
                image_channels=4, device="cpu", use_error_map=use_error_map)
    return state, step


def _teacher_jax(s, make, **kw):
    tree = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    opt = j_optim.build_optimizer(
        tree, j_label(s["spec_j"]), j_trainable(s["spec_j"], ""),
        j_optim.exp_decay_schedule(1e-2, ITERS),
        j_optim.exp_decay_schedule(1e-3, ITERS))
    state = JTrainState(params=tree, opt_state=opt.init(tree),
                        occ=s["occ_j"], step=jnp.int32(0),
                        ema_params=jax.tree_util.tree_map(jnp.array, tree))
    cfg = dataclasses.replace(s["cfg_j"], samples_per_ray=16.0)
    step = make(s["spec_j"], cfg.render_spec(), opt, cfg, INTR, H, W,
                image_channels=4, ema_decay=DECAY, use_error_map=True)
    return state, step


@pytest.fixture(scope="module")
def teacher():
    return build_teacher(SPEC_KW, 6)


def _ema_after_one_step(state, tree0):
    """The port's EMA weights against the JAX rule applied to the port's
    own params before and after the step."""
    want = j_optim.ema_update(tree0, tree_from_field(state.field), DECAY)
    got = tree_from_field(state.ema)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=EMA_RTOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ROWS)
def test_teacher_step_with_error_map_matches_jax(teacher, kind):
    """The preload teacher step with the error map and EMA: the JAX
    step's loss, metrics and updated row; the port's EMA weights."""
    s = teacher
    row = _row(kind)
    j_state, j_step = _teacher_jax(s, j_make_teacher)
    j_new, j_row, j_metrics = j_step(j_state, jnp.asarray(s["pose"]),
                                     jnp.asarray(s["image"]),
                                     jnp.asarray(row), KEY)
    k_rays, k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, 0), 3)
    rays = jax.jit(lambda k, e: j_get_rays(
        k, jnp.asarray(s["pose"])[None], INTR, H, W, 256,
        error_map=e[None]))(k_rays, jnp.asarray(row))
    inds = torch.from_numpy(np.asarray(rays["inds"][0], np.int64))
    cells = torch.from_numpy(np.asarray(rays["inds_coarse"][0], np.int64))
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg, (256, 3))))
    u = torch.from_numpy(np.array(jax.random.uniform(k_perturb, (256,))))
    image = torch.from_numpy(s["image"])

    state, step = _teacher_port(s, True)
    state, new_row, metrics = step.with_rays(
        state, s["pose"], image, torch.from_numpy(row), inds, cells, bg, u)
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=RTOL, err_msg=k)
    _ema_after_one_step(state, s["tree"])
    # the per-ray losses of the same step, for the cells drawn twice
    state2, _ = _teacher_port(s, True)
    r = get_rays(torch.from_numpy(s["pose"])[None], INTR, H, W, inds)
    _, _, per_ray = step.core(state2, r["rays_o"][0].contiguous(),
                              r["rays_d"][0].contiguous(), image[inds], bg,
                              u, per_ray=True)
    n_once, n_twice = _check_row(new_row.numpy(), np.asarray(j_row), row,
                                 cells, per_ray)
    assert n_once > 50 and (n_twice > 20 or kind == "spread")


def test_host_step_with_error_map_matches_jax(teacher):
    """The host-batcher step with the error map returns the per-ray
    losses of the JAX host step on the same batch."""
    s = teacher
    j_state, j_step = _teacher_jax(s, j_make_host)
    inds = np.random.default_rng(2).integers(0, H * W, 256).astype(np.int32)
    pix = s["image"][inds]
    j_new, j_per_ray, j_metrics = j_step(
        j_state, jnp.asarray(s["pose"]), jnp.asarray(inds),
        jnp.asarray(pix), KEY)
    k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, 0))
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg, (256, 3))))
    u = torch.from_numpy(np.array(jax.random.uniform(k_perturb, (256,))))
    state, step = _teacher_port(s, True, host=True)
    o, d = step.rays(s["pose"], inds)
    state, metrics, per_ray = step.core(state, o, d, torch.from_numpy(pix),
                                        bg, u, per_ray=True)
    np.testing.assert_allclose(per_ray.numpy(), np.asarray(j_per_ray),
                               rtol=RTOL,
                               atol=RTOL * float(np.abs(j_per_ray).max()))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=RTOL)
    _ema_after_one_step(state, s["tree"])
    # the step itself returns (state, per-ray losses, metrics)
    state, step = _teacher_port(s, True, host=True)
    out = step(state, s["pose"], inds, pix, torch.Generator().manual_seed(0))
    assert len(out) == 3 and out[1].shape == (256,)


@pytest.fixture(scope="module")
def distill():
    return build_distill(TEA_KW)


def _distill_port(s, stage, loss_type="L2"):
    cfg = PVDConfig(num_rays=256, grid_size=32, max_steps=128,
                    max_samples=32, samples_per_ray=8.0, precision="fp32",
                    resolution0=24, loss_type=loss_type)
    teacher = hash_field_from_jax(s["tea"], ModelSpec(**TEA_KW), "cpu")
    spec = ModelSpec(**STU_KW)
    student = vm_field_from_jax(s["stu"], spec, "cpu")
    params = dict(student.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.cosine_schedule(1e-2, ITERS), optim.cosine_schedule(1e-3,
                                                                  ITERS))
    occ = occupancy_from_jax(s["occ_j"], "cpu")
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    step = make_distill_step(spec, teacher.spec, cfg.render_spec(), opt, cfg,
                             (40.0, 40.0, 24.0, 24.0), 48, 48, stage,
                             device="cpu", use_error_map=True)
    return state, step, teacher, occ


def _distill_draws(s, row):
    k_rays, k_core = jax.random.split(jax.random.fold_in(KEY, 0))
    rays = jax.jit(lambda k, e: j_get_rays(
        k, jnp.asarray(s["pose"])[None], (40.0, 40.0, 24.0, 24.0), 48, 48,
        256, error_map=e[None]))(k_rays, jnp.asarray(row))
    k_bg, k_perturb = jax.random.split(k_core)
    return (torch.from_numpy(np.asarray(rays["inds"][0], np.int64)),
            torch.from_numpy(np.asarray(rays["inds_coarse"][0], np.int64)),
            torch.from_numpy(np.array(jax.random.uniform(k_bg, (256, 3)))),
            torch.from_numpy(np.array(jax.random.uniform(k_perturb,
                                                         (256,)))))


def test_distill_step_with_error_map_matches_jax(distill):
    """Stage 3 under the L2 loss: the JAX step's logs and updated row."""
    s = distill
    row = _row("peaked", 1)
    tree = jax.tree_util.tree_map(jnp.asarray, s["stu"])
    j_opt = j_optim.build_optimizer(
        tree, j_label(s["spec_sj"]), j_trainable(s["spec_sj"], ""),
        j_optim.cosine_schedule(1e-2, ITERS),
        j_optim.cosine_schedule(1e-3, ITERS))
    j_state = JTrainState(params=tree, opt_state=j_opt.init(tree),
                          occ=s["occ_j"], step=jnp.int32(0))
    j_step = j_make_distill(s["spec_sj"], s["spec_tj"], s["rspec_j"], j_opt,
                            s["cfg_j"], (40.0, 40.0, 24.0, 24.0), 48, 48,
                            stage=3, use_error_map=True)
    _, j_row, j_logs = j_step(
        j_state, jax.tree_util.tree_map(jnp.asarray, s["tea"]), s["occ_j"],
        jnp.asarray(s["pose"]), jnp.asarray(row), KEY)
    inds, cells, bg, u = _distill_draws(s, row)
    state, step, teacher, occ = _distill_port(s, 3)
    state, new_row, logs = step.with_rays(state, teacher, occ, s["pose"],
                                          torch.from_numpy(row), inds, cells,
                                          bg, u)
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k]), float(j_logs[k]),
                                   rtol=RTOL, err_msg=k)
    state2, step2, teacher, occ = _distill_port(s, 3)
    r = get_rays(torch.from_numpy(s["pose"])[None], (40.0, 40.0, 24.0, 24.0),
                 48, 48, inds)
    _, _, per_ray = step2.core(state2, teacher, occ,
                               r["rays_o"][0].contiguous(),
                               r["rays_d"][0].contiguous(), bg, u,
                               per_ray=True)
    n_once, n_twice = _check_row(new_row.numpy(), np.asarray(j_row), row,
                                 cells, per_ray)
    assert n_once > 50 and n_twice > 20


@pytest.mark.parametrize("stage,loss_type", [(1, "L2"), (2, "L2"),
                                             (3, "normL1")],
                         ids=["stage1", "stage2", "stage3-normL1"])
def test_distill_step_leaves_the_map(distill, stage, loss_type):
    """Only stage 3 under the L2 loss updates the map (train_steps.py:
    612-618); the draw still follows it."""
    s = distill
    row = torch.from_numpy(_row("peaked", 1))
    inds, cells, bg, u = _distill_draws(s, row.numpy())
    state, step, teacher, occ = _distill_port(s, stage, loss_type)
    state, new_row, logs = step.with_rays(state, teacher, occ, s["pose"],
                                          row, inds, cells, bg, u)
    assert torch.equal(new_row, row) and state.step == 1
    assert np.isfinite(float(logs["loss"]))


def _scene():
    return make_synthetic_scene(**SCENE, seed=0, scale=PVDConfig().scale)


def _touched(em, draws):
    """The map's cells that the draws (view, cells) hit."""
    want = np.zeros(em.shape, bool)
    for idx, cells in draws:
        want[idx, cells] = True
    return want


@pytest.mark.parametrize("preload", [True, False], ids=["preload", "host"])
def test_teacher_trainer_keeps_the_map(tmp_path, monkeypatch, preload):
    """Preloaded: a tensor map on the device, one row per training view,
    updated at every step.  Host batcher: a numpy map, each draw made on
    the host from the map as it stands, and each step's update landing
    one step late (trainer.py:736-747): a draw sees the updates of every
    step but the last, and after 3 steps the map holds those of the first
    two."""
    scene = _scene()
    cfg = PVDConfig(**dict(TRAINER_CFG, iters=3), error_map=True,
                    preload=preload, workspace=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    draws, seen = [], []

    def recording(rng, row, *a):
        em = tr.error_map
        idx = (row.ctypes.data - em.ctypes.data) // em.strides[0]
        seen.append(em != 1.0)
        out = draw_error_map_inds_np(rng, row, *a)
        draws.append((idx, out[1]))
        return out

    monkeypatch.setattr(trainer_mod, "draw_error_map_inds_np", recording)
    tr.train(scene["train"])
    em = tr.error_map
    assert em.shape == (SCENE["n_train"], ERROR_MAP_CELLS)
    assert isinstance(em, torch.Tensor) == preload
    em = em.numpy() if preload else em
    assert (em != 1.0).any() and np.isfinite(em).all()
    if preload:
        assert not draws
        return
    assert len(draws) == 3
    for i in range(3):  # draw i sees the updates of the steps before it
        assert np.array_equal(seen[i], _touched(em, draws[:i]))
    assert np.array_equal(em != 1.0, _touched(em, draws[:2]))


def test_distill_trainer_keeps_the_map(tmp_path):
    """A row per pose slot of the epoch, updated from stage 3 on."""
    scene = _scene()
    ws = tmp_path / "tea"
    tea = Trainer(PVDConfig(**TRAINER_CFG, workspace=str(ws)), device="cpu")
    tea.train(scene["train"])
    cfg = PVDConfig(**dict(TRAINER_CFG, iters=4, stage1_iters=1,
                           stage2_iters=2), teacher_type="vm",
                    error_map=True, workspace=str(tmp_path / "stu"))
    tr = Trainer(cfg, mode="distill", device="cpu")
    tr.load_teacher(ckpt.latest_checkpoint(str(ws / "checkpoints"), "vm"))
    seen = []
    make = tr._get_step_fn

    def recording(stage, *a, **kw):
        fn = make(stage, *a, **kw)

        def step(state, teacher, occ, pose, row, gen):
            out = fn(state, teacher, occ, pose, row, gen)
            seen.append((stage, bool(torch.equal(out[1], row))))
            return out
        return step

    tr._get_step_fn = recording
    tr.train(scene["train"])
    assert tr.error_map.shape == (312, ERROR_MAP_CELLS)
    assert [s for s, _ in seen] == [1, 2, 3, 3]
    assert [same for _, same in seen] == [True, True, False, False]


def test_ema_follows_jax_rule_over_steps(tmp_path):
    """Three preload teacher steps with EMA: the EMA weights equal the JAX
    package's ema_update applied along the port's own params."""
    scene = _scene()
    cfg = PVDConfig(**TRAINER_CFG, ema_decay=DECAY, preload=True,
                    workspace=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    want = tree_from_field(tr.state.field)
    tr.state.occ = tr.state.occ.replace(bitfield=torch.ones_like(
        tr.state.occ.bitfield))
    step = tr._get_step_fn(3, 24, 24, 4, scene["train"].intrinsics)
    images = torch.from_numpy(scene["train"].images_flat())
    poses = torch.from_numpy(scene["train"].poses)
    for i in range(3):
        tr.state, _ = step(tr.state, poses[i], images[i], tr.generator)
        want = j_optim.ema_update(want, tree_from_field(tr.state.field),
                                  DECAY)
    got = tree_from_field(tr.state.ema)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=EMA_RTOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert not np.array_equal(got["sigma_mat"][0],
                              tree_from_field(tr.state.field)["sigma_mat"][0])


def _same(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ema_best_checkpoint_reseed_and_restore(tmp_path):
    """The best checkpoint holds the EMA weights as params and as
    ema_params, the JAX reader reads them, evaluate renders them;
    load_teacher re-seeds the EMA from the warm-started student;
    load_student restores a JAX checkpoint's EMA weights, or copies the
    params where a checkpoint has none."""
    scene = _scene()
    cfg = PVDConfig(**TRAINER_CFG, ema_decay=DECAY, preload=True,
                    workspace=str(tmp_path / "tea"))
    tr = Trainer(cfg, device="cpu")
    rendered = []
    render = tr.eval_render

    def recording(field, *a):
        rendered.append(field)
        return render(field, *a)

    tr.eval_render = recording
    tr.train(scene["train"], valid_ds=scene["val"])
    assert rendered and all(f is tr.state.ema for f in rendered)
    best = os.path.join(cfg.workspace, "checkpoints", "vm_best.ckpt")
    payload = j_ckpt.load_checkpoint(best)
    ema = tree_from_field(tr.state.ema)
    _same(payload["params"], ema)
    _same(payload["ema_params"], ema)
    assert not np.array_equal(ema["sigma_mat"][0], tree_from_field(
        tr.state.field)["sigma_mat"][0])
    last = ckpt.latest_checkpoint(os.path.join(cfg.workspace, "checkpoints"),
                                  "vm")

    # load_teacher: the EMA restarts from the warm-started student
    dcfg = PVDConfig(**TRAINER_CFG, teacher_type="vm", ema_decay=DECAY,
                     workspace=str(tmp_path / "stu"))
    stu = Trainer(dcfg, mode="distill", device="cpu")
    stu.load_teacher(last)
    _same(tree_from_field(stu.state.ema), tree_from_field(stu.state.field))
    assert stu.state.ema is not stu.state.field

    # load_student: a JAX checkpoint's EMA weights, else the params
    again = Trainer(cfg, device="cpu")
    again.load_student(best)
    _same(tree_from_field(again.state.ema), ema)
    saved = ckpt.load_checkpoint(last, "cpu")
    moved = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1.0,
                                   saved["params"])
    path = j_ckpt.save_checkpoint(str(tmp_path / "jax"), "vm", 7,
                                  saved["params"], j_ckpt.load_checkpoint(
                                      last)["occ"], ema_params=moved)
    again.load_student(path)
    _same(tree_from_field(again.state.ema), moved)
    path = j_ckpt.save_checkpoint(str(tmp_path / "jax"), "vm", 8,
                                  saved["params"], j_ckpt.load_checkpoint(
                                      last)["occ"])
    again.load_student(path)
    _same(tree_from_field(again.state.ema), saved["params"])
    # EMA off: nothing kept, and checkpoints carry none
    plain = Trainer(dataclasses.replace(cfg, ema_decay=-1.0), device="cpu")
    plain.load_student(best)
    assert plain.state.ema is None
    assert j_ckpt.load_checkpoint(plain.save())["ema_params"] is None
