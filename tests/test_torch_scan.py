"""pvd_tpu_torch's K-step calls (`scan_steps`) on the CPU: against K single
steps of the port, against the JAX package's lax.scan steps, and the
Trainer's chunk schedule against the JAX Trainer's.

Sizes: the hash teacher of tests/test_torch_teacher.py (4 levels, 2^14
table, f32 heads; 256 rays of 48x48 RGBA images, grid 32, 128 march
steps, 16 samples per ray of budget) and the hash -> VM pair of
tests/test_torch_distill.py (8 samples per ray).

- A K-step call equals K single calls exactly (bit for bit on the CPU:
  the same ops in the same order): params, optimizer moments, logs, the
  error map and the per-ray losses, for the preload teacher, the host
  teacher and the distill step at stages 1-3, each with and without the
  error map; the draws come from one generator in step order.
- Against JAX's scan steps, the JAX draws are regenerated from its key in
  its order (fold_in(key, step) per step) and handed to the port; with
  the error map each step's draw is regenerated from the map as the
  earlier steps left it.  The learning rate is 0 in these cases, so every
  step's loss depends only on its draws, its image, the step counter and
  the carried map: Adam's first update turns rounding noise of near-zero
  gradients into steps of 2 x lr (tests/test_torch_teacher.py), which
  would blur those from step 2 on.  Tolerances: losses, metrics and
  per-ray losses rtol 2e-5 (the single steps' tolerance); the map after
  the chunk rtol 2e-5 plus 2e-5 of its max (a repeated cell holds its
  last ray's value in both packages).
- The chunk schedule: `Trainer._scan_chunk_len` equals the JAX Trainer's
  at every step of a schedule with ticks, stage changes and resizes, and
  the port Trainer's calls follow the JAX loop's chunks over a run with
  ticks and a resize (teacher) and a stage change (distill).  The host
  batcher's map lag: every draw of a chunk sees the map as it stood at
  the chunk's start, updated by every earlier call.

tests/test_torch_scan_trainer.py runs both packages' Trainers with scan
steps.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvd_tpu.engine import optim as j_optim
from pvd_tpu.engine.train_steps import TrainState as JTrainState
from pvd_tpu.engine.train_steps import make_distill_step as j_make_distill
from pvd_tpu.engine.train_steps import make_teacher_step as j_make_teacher
from pvd_tpu.engine.train_steps import \
    make_teacher_step_host as j_make_host
from pvd_tpu.engine.trainer import Trainer as JTrainer
from pvd_tpu.models.api import param_group_label as j_label
from pvd_tpu.models.api import trainable_label as j_trainable
from pvd_tpu.ops.rays import get_rays as j_get_rays
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
from pvd_tpu_torch.ops.rays import draw_error_map_inds_np
from pvd_tpu_torch.params import (hash_field_from_jax, occupancy_from_jax,
                                  vm_field_from_jax)
from test_torch_distill import STU_KW, TEA_KW
from test_torch_distill import _build as build_distill
from test_torch_teacher import H, INTR, ITERS, SPEC_KW, W
from test_torch_teacher import _build as build_teacher

torch.set_num_threads(1)

RTOL = 2e-5
K = 3
N = 256
EC = 128 * 128
KEY = jax.random.PRNGKey(13)
DIST_INTR = (40.0, 40.0, 24.0, 24.0)
TEACHER_FLAVORS = ("preload", "preload-emap", "host", "host-emap")
DISTILL_FLAVORS = [(st, emap) for st in (1, 2, 3) for emap in (False, True)]


@pytest.fixture(scope="module")
def teacher():
    s = build_teacher(SPEC_KW, 6)
    rng = np.random.default_rng(21)
    other = rng.uniform(size=s["image"].shape).astype(np.float32)
    other[:, 3] = rng.choice([0.0, 1.0, 0.3], size=H * W)
    s["images"] = np.stack([s["image"], other])
    s["emap"] = rng.uniform(0.05, 1.0, (2, EC)).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def distill():
    s = build_distill(TEA_KW)
    rng = np.random.default_rng(22)
    s["emap"] = rng.uniform(0.05, 1.0, (3, EC)).astype(np.float32)
    return s


def _poses(s, k, seed):
    """k poses: the fixture's pose turned about z by seeded angles."""
    rng = np.random.default_rng(seed)
    out = []
    for a in rng.uniform(-0.4, 0.4, k):
        rot = np.eye(4, dtype=np.float32)
        rot[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out.append((rot @ s["pose"]).astype(np.float32))
    return np.stack(out)


# ---- the port's states and steps ---------------------------------------

def _teacher_state(s, lr=1e-2):
    cfg = PVDConfig(num_rays=N, grid_size=32, max_steps=128, max_samples=32,
                    samples_per_ray=16.0, precision="fp32")
    spec = ModelSpec(**SPEC_KW)
    field = hash_field_from_jax(s["tree"], spec, "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.exp_decay_schedule(lr, ITERS),
        optim.exp_decay_schedule(lr * 0.1, ITERS))
    state = TrainState(field=field, opt_state=opt.init(params),
                       occ=occupancy_from_jax(s["occ_j"], "cpu"))
    return state, opt, cfg, spec


def _teacher_step(s, flavor, scan_steps, lr=1e-2):
    state, opt, cfg, spec = _teacher_state(s, lr)
    make = make_teacher_step_host if flavor.startswith("host") \
        else make_teacher_step
    step = make(spec, cfg.render_spec(), opt, cfg, INTR, H, W,
                image_channels=4, device="cpu",
                use_error_map=flavor.endswith("emap"),
                scan_steps=scan_steps)
    return state, step


def _distill_state(s, stage, emap, scan_steps, lr=1e-2):
    cfg = PVDConfig(num_rays=N, grid_size=32, max_steps=128, max_samples=32,
                    samples_per_ray=8.0, precision="fp32", resolution0=24)
    teacher = hash_field_from_jax(s["tea"], ModelSpec(**TEA_KW), "cpu")
    spec = ModelSpec(**STU_KW)
    student = vm_field_from_jax(s["stu"], spec, "cpu")
    params = dict(student.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.cosine_schedule(lr, ITERS),
        optim.cosine_schedule(lr * 0.1, ITERS))
    occ = occupancy_from_jax(s["occ_j"], "cpu")
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    step = make_distill_step(spec, teacher.spec, cfg.render_spec(), opt, cfg,
                             DIST_INTR, 48, 48, stage, device="cpu",
                             use_error_map=emap, scan_steps=scan_steps)
    return state, step, teacher, occ


def _same_state(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (n, x), (_, y) in zip(a.field.named_parameters(),
                              b.field.named_parameters()):
        assert torch.equal(x, y), n
    assert a.opt_state.count == b.opt_state.count
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k


def _same_logs(stacked: dict, singles: list):
    assert set(stacked) == set(singles[0])
    for k, v in stacked.items():
        assert v.shape == (len(singles),)
        assert torch.equal(v, torch.stack([m[k] for m in singles])), k


def _host_batches(s, k, seed=4):
    rng = np.random.default_rng(seed)
    inds = rng.integers(0, H * W, (k, N)).astype(np.int32)
    views = rng.integers(0, 2, k)
    return inds, np.stack([s["images"][v][i] for v, i in zip(views, inds)])


@pytest.mark.parametrize("flavor", TEACHER_FLAVORS)
def test_teacher_chunk_equals_single_steps(teacher, flavor):
    s = teacher
    idxs = np.array([1, 1, 0])
    poses = torch.from_numpy(_poses(s, K, 1))
    images = torch.from_numpy(s["images"])
    emap = torch.from_numpy(s["emap"])
    one, step = _teacher_step(s, flavor, 0)
    many, scan = _teacher_step(s, flavor, K)
    g1, gk = (torch.Generator().manual_seed(5) for _ in range(2))
    singles, rows = [], []
    if flavor.startswith("host"):
        inds, pix = _host_batches(s, K)
        for j in range(K):
            out = step(one, poses[j], inds[j], pix[j], g1)
            one, m = out[0], out[-1]
            singles.append(m)
            if flavor.endswith("emap"):
                rows.append(out[1])
        out = scan(many, poses, inds, pix, gk)
        many, logs = out[0], out[-1]
        if flavor.endswith("emap"):
            assert torch.equal(out[1], torch.stack(rows))
    elif flavor.endswith("emap"):
        em = emap.clone()
        for j, i in enumerate(idxs):
            one, em[i], m = step(one, poses[j], images[i], em[i], g1)
            singles.append(m)
        many, em_k, logs = scan(many, images, idxs, poses, emap, gk)
        assert torch.equal(em_k, em) and not torch.equal(em_k, emap)
        assert torch.equal(emap, torch.from_numpy(s["emap"]))  # a copy
    else:
        for j, i in enumerate(idxs):
            one, m = step(one, poses[j], images[i], g1)
            singles.append(m)
        many, logs = scan(many, images, idxs, poses, gk)
    assert many.step == K
    _same_state(one, many)
    _same_logs(logs, singles)
    assert torch.equal(g1.get_state(), gk.get_state())


@pytest.mark.parametrize("stage,emap", DISTILL_FLAVORS,
                         ids=[f"stage{st}{'-emap' if e else ''}"
                              for st, e in DISTILL_FLAVORS])
def test_distill_chunk_equals_single_steps(distill, stage, emap):
    s = distill
    poses = torch.from_numpy(_poses(s, K, 2))
    idxs = np.array([2, 2, 0])
    em0 = torch.from_numpy(s["emap"])
    one, step, tea, occ = _distill_state(s, stage, emap, 0)
    many, scan, _, _ = _distill_state(s, stage, emap, K)
    g1, gk = (torch.Generator().manual_seed(6) for _ in range(2))
    singles = []
    if emap:
        em = em0.clone()
        for j, i in enumerate(idxs):
            one, em[i], m = step(one, tea, occ, poses[j], em[i], g1)
            singles.append(m)
        many, em_k, logs = scan(many, tea, occ, poses, idxs, em0, gk)
        assert torch.equal(em_k, em)
        # only stage 3 under L2 updates the map (train_steps.py:547)
        assert torch.equal(em_k, em0) == (stage != 3)
    else:
        for j in range(K):
            one, m = step(one, tea, occ, poses[j], g1)
            singles.append(m)
        many, logs = scan(many, tea, occ, poses, gk)
    _same_state(one, many)
    _same_logs(logs, singles)


@pytest.mark.parametrize("flavor", TEACHER_FLAVORS + ("distill",
                                                      "distill-emap"))
def test_chunk_of_other_length_raises(teacher, distill, flavor):
    """A K-step call given the inputs of K - 1 steps raises before it
    trains: the state keeps its step and the generator its state."""
    poses = torch.from_numpy(_poses(teacher, K - 1, 1))
    g = torch.Generator().manual_seed(5)
    g0 = g.get_state()
    emap = flavor.endswith("emap")
    if flavor.startswith("distill"):
        state, scan, tea, occ = _distill_state(distill, 3, emap, K)
        args = (tea, occ, poses) + ((
            np.array([0, 1]), torch.from_numpy(distill["emap"])) if emap
            else ())
    elif flavor.startswith("host"):
        state, scan = _teacher_step(teacher, flavor, K)
        args = (poses,) + _host_batches(teacher, K - 1)
    else:
        state, scan = _teacher_step(teacher, flavor, K)
        args = (torch.from_numpy(teacher["images"]), np.array([1, 0]),
                poses) + ((torch.from_numpy(teacher["emap"]),) if emap
                          else ())
    with pytest.raises(ValueError, match=f"2 steps for a {K}-step call"):
        scan(state, *args, g)
    assert state.step == 0
    assert torch.equal(g.get_state(), g0)


# ---- against JAX's scan steps --------------------------------------------

def _jax_opt(tree, spec_j, sched):
    return j_optim.build_optimizer(tree, j_label(spec_j),
                                   j_trainable(spec_j, ""), sched(0.0, ITERS),
                                   sched(0.0, ITERS))


def _jax_state(tree, opt, occ_j):
    return JTrainState(params=tree, opt_state=opt.init(tree), occ=occ_j,
                       step=jnp.int32(0))


def _uniform(k, shape):
    return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


def _draw(k_rays, pose, intr, row):
    """JAX's get_rays draw (pixel ids, cells) under jit, as its step
    draws it; `row` None for uniform pixels."""
    if row is None:
        out = jax.jit(lambda k: j_get_rays(k, jnp.asarray(pose)[None], intr,
                                           48, 48, N))(k_rays)
    else:
        out = jax.jit(lambda k, e: j_get_rays(
            k, jnp.asarray(pose)[None], intr, 48, 48, N,
            error_map=e[None]))(k_rays, jnp.asarray(row))
    inds = torch.from_numpy(np.asarray(out["inds"][0], np.int64))
    if row is None:
        return inds, None
    return inds, torch.from_numpy(np.asarray(out["inds_coarse"][0],
                                             np.int64))


def _check_logs(logs, j_logs):
    for k in j_logs:
        np.testing.assert_allclose(logs[k].numpy(), np.asarray(j_logs[k]),
                                   rtol=RTOL, err_msg=k)


def _check_map(got, want, old):
    """The map after the chunk against JAX's: repeated cells keep their
    last ray's value in both packages (XLA:CPU's scatter and the port's
    `error_map_update`), so every cell compares at the loss tolerance."""
    assert not np.array_equal(got, old)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("emap", [False, True], ids=["plain", "emap"])
def test_teacher_scan_matches_jax(teacher, emap):
    """JAX's make_teacher_step(scan_steps=K): images [0, 0, 1] from three
    poses, the second draw on image 0 from the map after the first."""
    s = teacher
    idxs = np.array([0, 0, 1])
    poses = _poses(s, K, 3)
    tree = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    j_opt = _jax_opt(tree, s["spec_j"], j_optim.exp_decay_schedule)
    j_step = j_make_teacher(s["spec_j"], s["cfg_j"].render_spec(), j_opt,
                            s["cfg_j"], INTR, H, W, image_channels=4,
                            use_error_map=emap, scan_steps=K)
    args = (_jax_state(tree, j_opt, s["occ_j"]), jnp.asarray(s["images"]),
            jnp.asarray(idxs, jnp.int32), jnp.asarray(poses))
    if emap:
        _, j_em, j_logs = j_step(*args, jnp.asarray(s["emap"]), KEY)
    else:
        _, j_logs = j_step(*args, KEY)

    # JAX's draws, regenerated step by step; with the map, each from the
    # row as the port's single steps (lr 0) left it
    flavor = "preload-emap" if emap else "preload"
    one_state, one = _teacher_step(s, flavor, 0, lr=0.0)
    images = torch.from_numpy(s["images"])
    em = torch.from_numpy(s["emap"]).clone()
    draws = []
    for j, i in enumerate(idxs):
        k_rays, k_bg, k_perturb = jax.random.split(
            jax.random.fold_in(KEY, j), 3)
        inds, cells = _draw(k_rays, poses[j], INTR,
                            em[i].numpy() if emap else None)
        bg, u = _uniform(k_bg, (N, 3)), _uniform(k_perturb, (N,))
        if emap:
            draws.append((inds, cells, bg, u))
            one_state, em[i], _ = one.with_rays(one_state, poses[j],
                                                images[i], em[i], *draws[-1])
        else:
            draws.append((inds, bg, u))
    state, scan = _teacher_step(s, flavor, K, lr=0.0)
    if emap:
        state, em_k, logs = scan.with_rays(
            state, images, idxs, torch.from_numpy(poses),
            torch.from_numpy(s["emap"]), draws)
        assert torch.equal(em_k, em)
        _check_map(em_k.numpy(), np.asarray(j_em), s["emap"])
    else:
        state, logs = scan.with_rays(state, images, idxs,
                                     torch.from_numpy(poses), draws)
    _check_logs(logs, j_logs)


def test_host_scan_matches_jax(teacher):
    """JAX's make_teacher_step_host(scan_steps=K): the per-ray losses and
    the logs of K steps on the host's K batches."""
    s = teacher
    poses = _poses(s, K, 4)
    inds, pix = _host_batches(s, K, seed=7)
    tree = jax.tree_util.tree_map(jnp.asarray, s["tree"])
    j_opt = _jax_opt(tree, s["spec_j"], j_optim.exp_decay_schedule)
    j_step = j_make_host(s["spec_j"], s["cfg_j"].render_spec(), j_opt,
                         s["cfg_j"], INTR, H, W, image_channels=4,
                         scan_steps=K)
    _, j_per, j_logs = j_step(_jax_state(tree, j_opt, s["occ_j"]),
                              jnp.asarray(poses), jnp.asarray(inds),
                              jnp.asarray(pix), KEY)
    draws = []
    for j in range(K):
        k_bg, k_perturb = jax.random.split(jax.random.fold_in(KEY, j))
        draws.append((_uniform(k_bg, (N, 3)), _uniform(k_perturb, (N,))))
    state, scan = _teacher_step(s, "host-emap", K, lr=0.0)
    state, per_rays, logs = scan.with_rays(state, torch.from_numpy(poses),
                                           inds, pix, draws)
    j_per = np.asarray(j_per)
    np.testing.assert_allclose(per_rays.numpy(), j_per, rtol=RTOL,
                               atol=RTOL * float(np.abs(j_per).max()))
    _check_logs(logs, j_logs)


@pytest.mark.parametrize("stage,emap", [(2, False), (3, True)],
                         ids=["stage2", "stage3-emap"])
def test_distill_scan_matches_jax(distill, stage, emap):
    """JAX's make_distill_step(scan_steps=K): with the map, pose slots
    [1, 1, 2]; the step counter drives the feature rate's decay."""
    s = distill
    poses = _poses(s, K, 5)
    idxs = np.array([1, 1, 2])
    stu = jax.tree_util.tree_map(jnp.asarray, s["stu"])
    tea = jax.tree_util.tree_map(jnp.asarray, s["tea"])
    j_opt = _jax_opt(stu, s["spec_sj"], j_optim.cosine_schedule)
    j_step = j_make_distill(s["spec_sj"], s["spec_tj"], s["rspec_j"], j_opt,
                            s["cfg_j"], DIST_INTR, 48, 48, stage=stage,
                            use_error_map=emap, scan_steps=K)
    j_state = _jax_state(stu, j_opt, s["occ_j"])
    if emap:
        _, j_em, j_logs = j_step(j_state, tea, s["occ_j"],
                                 jnp.asarray(poses),
                                 jnp.asarray(idxs, jnp.int32),
                                 jnp.asarray(s["emap"]), KEY)
    else:
        _, j_logs = j_step(j_state, tea, s["occ_j"], jnp.asarray(poses),
                           KEY)

    one_state, one, tea_p, occ_p = _distill_state(s, stage, emap, 0,
                                                  lr=0.0)
    em = torch.from_numpy(s["emap"]).clone()
    draws = []
    for j in range(K):
        k_rays, k_core = jax.random.split(jax.random.fold_in(KEY, j))
        i = idxs[j]
        inds, cells = _draw(k_rays, poses[j], DIST_INTR,
                            em[i].numpy() if emap else None)
        k_bg, k_perturb = jax.random.split(k_core)
        bg, u = _uniform(k_bg, (N, 3)), _uniform(k_perturb, (N,))
        if emap:
            draws.append((inds, cells, bg, u))
            one_state, em[i], _ = one.with_rays(one_state, tea_p, occ_p,
                                                poses[j], em[i], *draws[-1])
        else:
            draws.append((inds, bg, u))
    state, scan, _, _ = _distill_state(s, stage, emap, K, lr=0.0)
    poses_t = torch.from_numpy(poses)
    if emap:
        state, em_k, logs = scan.with_rays(state, tea_p, occ_p, poses_t,
                                           idxs, torch.from_numpy(s["emap"]),
                                           draws)
        assert torch.equal(em_k, em)
        _check_map(em_k.numpy(), np.asarray(j_em), s["emap"])
    else:
        state, logs = scan.with_rays(state, tea_p, occ_p, poses_t, draws)
    assert state.step == K
    _check_logs(logs, j_logs)


# ---- the Trainer's chunk schedule ----------------------------------------

SCHED = dict(scan_steps=4, update_extra_interval=6, stage1_iters=10,
             stage2_iters=23, upsample_model_steps=(13, 30))


def _jax_chunk_len(cfg_kw, mode):
    """The JAX Trainer's _scan_chunk_len on a stand-in holding what it
    reads (its config, mode, resize steps and stage rule)."""
    from pvd_tpu.config import PVDConfig as JPVDConfig

    me = types.SimpleNamespace(cfg=JPVDConfig(**cfg_kw), mode=mode,
                               upsample_steps=list(
                                   cfg_kw["upsample_model_steps"]))
    me._stage_of = lambda step: JTrainer._stage_of(me, step)
    return lambda *a: JTrainer._scan_chunk_len(me, *a)


@pytest.mark.parametrize("mode", ["teacher", "distill"])
def test_chunk_len_equals_jax(mode):
    tr = Trainer(PVDConfig(**SCHED, model_type="vm", resolution0=16),
                 mode=mode, device="cpu")
    want = _jax_chunk_len(SCHED, mode)
    total = 47
    n_chunks = 0
    for step in range(total):
        for left in (1, 3, 4, 9):
            stage = tr._stage_of(step)
            got = tr._scan_chunk_len(step, stage, total, left)
            assert got == want(step, stage, total, left), (step, left)
            n_chunks += got > 1
    assert n_chunks >= 6  # chunks and cut chunks both met


def _jax_loop_calls(chunk_len, stage_of, total, epoch_len):
    """The (step, K) of each call of the JAX Trainer's loop
    (trainer.py:701-960) under `chunk_len`."""
    calls, step = [], 0
    while step < total:
        todo, done = min(epoch_len, total - step), 0
        while done < todo:
            k = chunk_len(step, stage_of(step), total, todo - done)
            calls.append((step, k))
            step += k
            done += k
    return calls


SCENE = dict(n_train=5, n_val=1, n_test=1, H=24, W=24)
SMALL = dict(model_type="vm", resolution0=16, num_rays=64, grid_size=16,
             max_steps=64, max_samples=16, samples_per_ray=0.0,
             autotune_budget=False, precision="fp32", eval_interval=10 ** 6)


def _recorded_calls(tr):
    """Record (trainer step, scan_steps) of each step call the Trainer
    makes."""
    calls = []
    make = tr._get_step_fn

    def recording(stage, H_, W_, C, intr, host=False, scan_steps=0):
        fn = make(stage, H_, W_, C, intr, host=host, scan_steps=scan_steps)

        def call(state, *a):
            calls.append((state.step, scan_steps or 1))
            return fn(state, *a)
        return call

    tr._get_step_fn = recording
    return calls


def test_trainer_chunks_follow_jax_loop(tmp_path):
    """A VM teacher (ticks every 6 steps, resizes after 13 and 30) and a
    distilled student (stages at 10 and 23, 5-pose epochs would cut
    chunks; the synthetic epoch has 312 poses): the port Trainer's calls
    are the JAX loop's."""
    scene = make_synthetic_scene(**SCENE, seed=0, scale=PVDConfig().scale)
    kw = dict(SMALL, **SCHED, iters=37)
    tea = Trainer(PVDConfig(**kw, preload=True, resolution1=20,
                            workspace=str(tmp_path / "t")), device="cpu")
    tea.upsample_resolutions = [18, 20]
    calls = _recorded_calls(tea)
    tea.train(scene["train"])
    want = _jax_loop_calls(_jax_chunk_len(kw, "teacher"), lambda s: 3, 37,
                           SCENE["n_train"])
    assert calls == want and any(k > 1 for _, k in calls)
    assert tea.state.step == 37 and len(tea.history) == 37
    assert tea.train_stats["chunk_steps"] == sum(k for _, k in calls
                                                 if k > 1)
    assert tea.spec_stu.vm_resolution != (16, 16, 16)  # resized

    stu = Trainer(PVDConfig(**kw, teacher_type="vm",
                            workspace=str(tmp_path / "s")),
                  mode="distill", device="cpu")
    stu.load_teacher(ckpt.latest_checkpoint(str(tmp_path / "t" /
                                                "checkpoints"), "vm"))
    stu.upsample_resolutions = [18, 20]
    calls = _recorded_calls(stu)
    stu.train(scene["train"])
    want = _jax_loop_calls(_jax_chunk_len(kw, "distill"), stu._stage_of, 37,
                           312)
    assert calls == want
    assert stu.state.step == 37 and len(stu.history) == 37


def test_host_chunk_map_lag(tmp_path, monkeypatch):
    """The host batcher with the error map and scan_steps=4: each draw of
    a chunk sees the map as it stood at the chunk's start, with the
    updates of every earlier call; after the run the map holds all but the
    last call's (trainer.py:736-795).  Eight views: an epoch of 8 steps."""
    scene = make_synthetic_scene(**dict(SCENE, n_train=8), seed=0,
                                 scale=PVDConfig().scale)
    cfg = PVDConfig(**dict(SMALL, iters=11, scan_steps=4,
                           update_extra_interval=8), error_map=True,
                    preload=False, workspace=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    draws, seen = [], []

    def recording(rng, row, *a):
        em = tr.error_map
        idx = (row.ctypes.data - em.ctypes.data) // em.strides[0]
        seen.append(em.copy())
        out = draw_error_map_inds_np(rng, row, *a)
        draws.append((idx, out[1]))
        return out

    monkeypatch.setattr(trainer_mod, "draw_error_map_inds_np", recording)
    calls = _recorded_calls(tr)
    tr.train(scene["train"])
    # steps 0-7: chunks at 0 and 4 (tick at 8 cuts 8-11): 8, 9, 10 single
    assert [k for _, k in calls] == [4, 4, 1, 1, 1]
    starts = [0, 0, 0, 0, 4, 4, 4, 4, 8, 9, 10]
    em = np.ones_like(tr.error_map)
    applied = 0
    for step, (idx, cells) in enumerate(draws):
        # the updates that have landed: every call before this one's
        while applied < starts[step]:
            i, c = draws[applied]
            em[i, c] = 0.5  # a marker: the cell was written
            applied += 1
        touched = seen[step] != 1.0
        assert np.array_equal(touched, em != 1.0), step
    assert np.array_equal(tr.error_map != 1.0, _touched(tr.error_map,
                                                        draws[:10]))


def _touched(em, draws):
    want = np.zeros(em.shape, bool)
    for idx, cells in draws:
        want[idx, cells] = True
    return want
