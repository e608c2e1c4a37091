"""pvd_tpu_torch's data parallelism over the ray axis (`parallel/`) on the
CPU: gloo process groups of 2 and 4 ranks, one torch thread a rank, every
process started with torch.multiprocessing (spawn) against a `file://`
rendezvous under the test's tmp dir and joined with a time limit.

Each world runs one set of ranks, which write their results to files;
the tests compare them against the JAX package and against the
single-process port.  Sizes: the hash teacher of
tests/test_torch_teacher.py (padded path, 256 rays of a 48x48 RGBA
image) and the hash -> VM pair of tests/test_torch_distill.py (8 samples
per ray of budget), the rays split into fixed shards in rank order.

Against JAX (a `jax.shard_map` over `teacher_loss` / `distill_loss` with
check_vma=False on a 2- or 4-device mesh of the tests' 8 virtual CPU
devices, the form of tests/test_parallel.py:91, without perturbation):
  * the averaged teacher and distill gradients: 2e-5 of the leaf's max
    |g| plus rtol 1e-4 (the single steps' gradient tolerance,
    tests/test_torch_distill.py), the distill one with its per-shard
    point-loss normalisation on both sides;
  * the rgb-only distill objective also at tests/test_parallel.py's
    rtol 2e-3, atol 1e-6 against JAX's single-chip gradient.
Against the single-process port on the concatenated batch:
  * the DP teacher step with the error map and the rgb-only distill step
    with the error map: loss and metrics rtol 2e-5 (not the distill's
    point losses and PSNR, means of per-shard values as in JAX:
    `SHARD_LOGS`), gradients as above,
    params after the step 1e-6 where the gradient is clear of rounding
    noise (tests/test_torch_teacher.py), the updated map row rtol 2e-5
    plus 2e-5 of its max (a repeated cell keeps its last ray in both);
  * the DP occupancy sweep (full and partial): density grid rtol 1e-6,
    bitfield equal; the DP eval image: 1e-6 absolute;
  * the DP scan (K = 2) equals two DP single steps exactly, and every
    rank ends with the same params, occupancy and map, bit for bit.
Through the Trainer (2 ranks): a teacher with the error map and scan
steps and a student each raise their batch PSNR; the teacher CLI under
--n_devices 2 writes its workspace from rank 0; n_devices against the
wrong world size raises.
"""

import os
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)

N = 256
H = W = 48
INTR = (40.0, 40.0, 24.0, 24.0)
ITERS = 100
EC = 128 * 128
WORLDS = (2, 4)
JOIN_S = 240  # a world's time limit
GRAD_REL_ATOL, GRAD_RTOL = 2e-5, 1e-4
LOSS_RTOL, PARAM_TOL, MASK_FRAC = 2e-5, 1e-6, 1e-3
RGB_ONLY = dict(loss_rate_fea_sc=0.0, loss_rate_sigma=0.0,
                loss_rate_color=0.0)
TEA_CFG = dict(num_rays=N, grid_size=32, max_steps=128, max_samples=32,
               samples_per_ray=0.0, precision="fp32")
DIS_CFG = dict(num_rays=N, grid_size=32, max_steps=128, max_samples=32,
               samples_per_ray=8.0, precision="fp32", resolution0=24)
TRAINER_CFG = dict(model_type="vm", resolution0=16, num_rays=126,
                   grid_size=16, max_steps=64, max_samples=16,
                   samples_per_ray=4.0, precision="fp32", iters=48,
                   update_extra_interval=4, density_thresh=0.01, lr=2e-2,
                   eval_interval=10 ** 6, n_devices=2)
SCENE = dict(n_train=4, n_val=1, n_test=1, H=24, W=24)
# distill logs that are the ranks' mean of per-shard values, as in JAX
# (dp.py:15-23): the point losses (each shard's own valid count) and the
# PSNR (a mean of logs); the rest split exactly over equal shards
SHARD_LOGS = ("loss_fea_sc", "loss_sigma", "loss_color", "psnr")


# ---- the port's side (ranks and the single-process reference) ------------

def _occ(s):
    from pvd_tpu_torch.params import occupancy_from_jax

    return occupancy_from_jax(types.SimpleNamespace(**s["occ"]), "cpu")


def _teacher_state(s):
    from pvd_tpu_torch.config import ModelSpec, PVDConfig
    from pvd_tpu_torch.engine import optim
    from pvd_tpu_torch.engine.train_steps import TrainState
    from pvd_tpu_torch.models.api import param_group_label, trainable_label
    from pvd_tpu_torch.params import hash_field_from_jax

    cfg = PVDConfig(**TEA_CFG)
    spec = ModelSpec(**s["spec_kw"])
    field = hash_field_from_jax(s["tree"], spec, "cpu")
    params = dict(field.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.exp_decay_schedule(1e-2, ITERS),
        optim.exp_decay_schedule(1e-3, ITERS))
    state = TrainState(field=field, opt_state=opt.init(params), occ=_occ(s))
    return state, opt, cfg, spec


def _distill_state(d, rgb_only):
    from pvd_tpu_torch.config import ModelSpec, PVDConfig
    from pvd_tpu_torch.engine import optim
    from pvd_tpu_torch.engine.train_steps import TrainState
    from pvd_tpu_torch.models.api import param_group_label, trainable_label
    from pvd_tpu_torch.params import hash_field_from_jax, vm_field_from_jax

    cfg = PVDConfig(**DIS_CFG, **(RGB_ONLY if rgb_only else {}))
    teacher = hash_field_from_jax(d["tea"], ModelSpec(**d["tea_kw"]), "cpu")
    spec = ModelSpec(**d["stu_kw"])
    student = vm_field_from_jax(d["stu"], spec, "cpu")
    params = dict(student.named_parameters())
    opt = optim.build_optimizer(
        params, param_group_label(spec), trainable_label(spec, ""),
        optim.cosine_schedule(1e-2, ITERS), optim.cosine_schedule(1e-3,
                                                                  ITERS))
    occ = _occ(d)
    state = TrainState(field=student, opt_state=opt.init(params), occ=occ)
    return state, opt, cfg, spec, teacher, occ


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _teacher_out(state, metrics, row):
    from pvd_tpu_torch.params import hash_tree_from_field

    return dict(grads=hash_tree_from_field(state.field, grad=True),
                params=hash_tree_from_field(state.field),
                metrics={k: float(v) for k, v in metrics.items()},
                row=row.numpy())


def _distill_out(state, logs, row):
    from pvd_tpu_torch.params import vm_tree_from_field

    return dict(grads=vm_tree_from_field(state.field, grad=True),
                params=vm_tree_from_field(state.field),
                metrics={k: float(v) for k, v in logs.items()},
                row=row.numpy())


def teacher_step_on(s, inputs, group=None):
    """One teacher step with the error map on `inputs` (all N rays, or
    the rank's slice with a group)."""
    from pvd_tpu_torch.engine.train_steps import make_teacher_step

    state, opt, cfg, spec = _teacher_state(s)
    step = make_teacher_step(spec, cfg.render_spec(), opt, cfg, INTR, H, W,
                             image_channels=4, device="cpu",
                             use_error_map=True, group=group)
    sl = slice(None) if group is None else group.ray_slice(N)
    state, row, metrics = step.with_rays(
        state, _t(s["pose"]), _t(s["image"]), _t(s["row"]),
        _t(inputs["inds"][sl]), _t(inputs["cells"][sl]),
        _t(inputs["bg"][sl]), None)
    return _teacher_out(state, metrics, row)


def distill_step_on(d, inputs, rgb_only, group=None):
    """One stage-3 distill step with the error map on `inputs`."""
    from pvd_tpu_torch.engine.train_steps import make_distill_step

    state, opt, cfg, spec, teacher, occ = _distill_state(d, rgb_only)
    step = make_distill_step(spec, teacher.spec, cfg.render_spec(), opt,
                             cfg, INTR, H, W, 3, device="cpu",
                             use_error_map=True, group=group)
    sl = slice(None) if group is None else group.ray_slice(N)
    state.step = 7
    state, row, logs = step.with_rays(
        state, teacher, occ, _t(d["pose"]), _t(d["row"]),
        _t(inputs["inds"][sl]), _t(inputs["cells"][sl]),
        _t(inputs["bg"][sl]), None)
    return _distill_out(state, logs, row)


def _occ_inputs(s, full, world=None):
    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.render.occupancy import draw_occ_inputs

    rspec = PVDConfig(**TEA_CFG).render_spec()
    gen = torch.Generator().manual_seed(9)
    occ = _occ(s)
    if not full:  # a grid with densities, so the partial draw resamples
        occ = occ.replace(density_grid=torch.from_numpy(s["density"]))
    return occ, rspec, draw_occ_inputs(gen, occ, rspec, full)


def sweep_on(s, full, group=None):
    from pvd_tpu_torch.engine.train_steps import make_occ_update
    from pvd_tpu_torch.parallel.dp import make_dp_occ_update

    state, _, _, spec = _teacher_state(s)
    occ, rspec, (jitter, coords) = _occ_inputs(s, full)
    upd = (make_occ_update(spec, rspec, device="cpu") if group is None
           else make_dp_occ_update(spec, rspec, group, device="cpu"))
    out = upd(occ, state.field, full=full, jitter=jitter, coords=coords)
    return dict(grid=out.density_grid.numpy(), bits=out.bitfield.numpy(),
                mean=float(out.mean_density))


def eval_on(s, group=None):
    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.engine.train_steps import make_eval_renderer
    from pvd_tpu_torch.parallel.dp import make_dp_eval_renderer

    state, _, _, spec = _teacher_state(s)
    # 2 samples per ray of budget: the ~6 a ray needs take the ladder up
    rspec = PVDConfig(**dict(TEA_CFG, samples_per_ray=2.0)).render_spec()
    render = (make_eval_renderer(spec, rspec, chunk=1000, device="cpu")
              if group is None else
              make_dp_eval_renderer(spec, rspec, group, chunk=1000,
                                    device="cpu"))
    out = render(state.field, _occ(s), s["pose"], INTR, H, W)
    return dict(image=out.image.numpy(), depth=out.depth.numpy(),
                ws=out.weights_sum.numpy(), rungs=out.rungs,
                samples=out.samples, trunc=out.truncated_chunks)


def _scan_check(s, group):
    """A K = 2 DP chunk against two DP single steps from one rank
    generator: equal bit for bit; returns the chunk's params and map."""
    from pvd_tpu_torch.engine.train_steps import make_teacher_step
    from pvd_tpu_torch.params import hash_tree_from_field

    outs = []
    for k in (0, 2):
        state, opt, cfg, spec = _teacher_state(s)
        step = make_teacher_step(spec, cfg.render_spec(), opt, cfg, INTR, H,
                                 W, image_channels=4, device="cpu",
                                 use_error_map=True, scan_steps=k,
                                 group=group)
        gen = torch.Generator().manual_seed(100 + group.rank)
        images = _t(np.stack([s["image"], s["image"][::-1].copy()]))
        poses = _t(np.stack([s["pose"], s["pose"]]))
        em = _t(np.stack([s["row"], s["row"]])).clone()
        if k:
            state, em, logs = step(state, images, [1, 1], poses, em, gen)
        else:
            for j in range(2):
                state, em[1], _ = step(state, poses[j], images[1], em[1],
                                       gen)
        outs.append((hash_tree_from_field(state.field), em.numpy()))
    (p1, m1), (pk, mk) = outs
    same = np.array_equal(m1, mk) and all(
        np.array_equal(a, b) for a, b in zip(_flat(p1), _flat(pk)))
    return dict(same=same, params=pk, map=mk)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _trainer_runs(rank, tmp):
    """Two-rank Trainer runs: a teacher (error map, scan steps) and its
    student, the teacher CLI, and the wrong world size."""
    from pvd_tpu_torch.cli import train_teacher as teacher_cli
    from pvd_tpu_torch.config import PVDConfig
    from pvd_tpu_torch.data.synth import (make_synthetic_scene,
                                          write_synthetic_scene)
    from pvd_tpu_torch.engine.trainer import Trainer
    from pvd_tpu_torch.params import tree_from_field

    out = {}
    scene = make_synthetic_scene(**SCENE, seed=0, scale=PVDConfig().scale)
    tea = Trainer(PVDConfig(**TRAINER_CFG, error_map=True, scan_steps=2,
                            workspace=os.path.join(tmp, "tea")),
                  device="cpu")
    tea.train(scene["train"], valid_ds=scene["val"])
    out["tea_cfg"] = (tea.cfg.num_rays, tea.cfg.preload)
    out["tea_psnr"] = [float(m["psnr"]) for m in tea.history]
    out["tea_eval"] = tea.evaluate(scene["test"])["psnr"]
    out["tea_params"] = _flat(tree_from_field(tea.state.field))
    out["tea_occ"] = tea.state.occ.density_grid.numpy()
    out["tea_map"] = tea.error_map.numpy()
    path = os.path.join(tmp, "tea", "checkpoints", "vm_best.ckpt")
    stu = Trainer(PVDConfig(**dict(TRAINER_CFG, stage1_iters=8,
                                   stage2_iters=16), teacher_type="vm",
                            scan_steps=4,
                            workspace=os.path.join(tmp, "stu")),
                  mode="distill", device="cpu")
    stu.load_teacher(path)
    stu.train(scene["train"])
    out["stu_psnr"] = [float(m["psnr"]) for m in stu.history
                       if "psnr" in m]
    out["stu_params"] = _flat(tree_from_field(stu.state.field))

    root = os.path.join(tmp, "scene")
    if rank == 0:
        write_synthetic_scene(root, n_train=4, n_val=0, n_test=1, H=24,
                              W=24, seed=1)
    torch.distributed.barrier()
    ws = os.path.join(tmp, "cli")
    stats = teacher_cli.main([
        root, "--workspace", ws, "--model_type", "vm", "--resolution0",
        "16", "--iters", "12", "--num_rays", "63", "--grid_size", "16",
        "--max_steps", "64", "--precision", "fp32", "--n_devices", "2",
        "--scan_steps", "2", "--eval_interval", "1000"], device="cpu")
    out["cli_psnr"] = stats["psnr"]
    try:
        Trainer(PVDConfig(**dict(TRAINER_CFG, n_devices=3)), device="cpu")
        out["wrong_world"] = "no error"
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


def _rank_main(rank, world, initf, outdir, payload):
    """A rank: join the gloo group, run every check, write the results."""
    torch.set_num_threads(1)
    from pvd_tpu_torch.parallel.mesh import init_ray_group

    group = init_ray_group("cpu", backend="gloo",
                           init_method="file://" + initf, rank=rank,
                           world_size=world, timeout_s=JOIN_S)
    s, d, inputs = payload["teacher"], payload["distill"], payload["inputs"]
    res = dict(
        rank=rank, world=group.world,
        teacher=teacher_step_on(s, inputs["teacher"], group),
        distill=distill_step_on(d, inputs["distill"], False, group),
        distill_rgb=distill_step_on(d, inputs["distill"], True, group),
        sweep_full=sweep_on(s, True, group),
        sweep_partial=sweep_on(s, False, group),
        eval=eval_on(s, group), scan=_scan_check(s, group))
    if world == 2:
        res["trainer"] = _trainer_runs(rank, outdir)
        res["tmp"] = outdir
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _run_world(world, tmp, payload):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "rendezvous"),
                               tmp, payload)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0] * world, codes
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---- the JAX side and the fixtures ----------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The two fixtures' numpy parts, the fixed shards' inputs, and each
    world's rank results."""
    import jax

    from pvd_tpu.ops.rays import get_rays as j_get_rays
    from test_torch_distill import STU_KW, TEA_KW
    from test_torch_distill import _build as build_distill
    from test_torch_teacher import SPEC_KW
    from test_torch_teacher import _build as build_teacher

    st, sd = build_teacher(SPEC_KW, 6), build_distill(TEA_KW)

    def occ_np(o):
        return {k: np.asarray(getattr(o, k)) for k in (
            "density_grid", "bitfield", "mean_density", "iter_density",
            "aabb_train", "aabb_infer")}

    rng = np.random.default_rng(17)
    teacher = dict(spec_kw=SPEC_KW, tree=st["tree"], occ=occ_np(st["occ_j"]),
                   pose=st["pose"], image=st["image"],
                   row=rng.uniform(0.05, 1.0, EC).astype(np.float32),
                   density=rng.uniform(-1.0, 30.0, (1, 32, 32, 32))
                   .astype(np.float32))
    distill = dict(tea_kw=TEA_KW, stu_kw=STU_KW, tea=sd["tea"], stu=sd["stu"],
                   occ=occ_np(sd["occ_j"]), pose=sd["pose"],
                   row=rng.uniform(0.05, 1.0, EC).astype(np.float32))

    def shards(pose, key):
        rays = jax.jit(lambda k, p: j_get_rays(k, p[None], INTR, H, W, N))(
            jax.random.PRNGKey(key), np.asarray(pose))
        return dict(inds=np.asarray(rays["inds"][0], np.int64),
                    o=np.asarray(rays["rays_o"][0]),
                    d=np.asarray(rays["rays_d"][0]),
                    cells=rng.integers(0, 600, N).astype(np.int64),
                    bg=rng.uniform(size=(N, 3)).astype(np.float32))

    inputs = dict(teacher=shards(st["pose"], 9),
                  distill=shards(sd["pose"], 10))
    payload = dict(teacher=teacher, distill=distill, inputs=inputs)
    return dict(st=st, sd=sd, payload=payload, ranks={})


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, setup, tmp_path_factory):
    w = request.param
    if w not in setup["ranks"]:
        tmp = str(tmp_path_factory.mktemp(f"dp{w}"))
        setup["ranks"][w] = _run_world(w, tmp, setup["payload"])
    return w, setup["ranks"][w]


@pytest.fixture(scope="module")
def single(setup):
    """The single-process port on the concatenated batch."""
    p = setup["payload"]
    return dict(
        teacher=teacher_step_on(p["teacher"], p["inputs"]["teacher"]),
        distill_rgb=distill_step_on(p["distill"], p["inputs"]["distill"],
                                    True),
        sweep_full=sweep_on(p["teacher"], True),
        sweep_partial=sweep_on(p["teacher"], False),
        eval=eval_on(p["teacher"]))


def _mesh(w):
    import jax

    from pvd_tpu.parallel import make_ray_mesh

    assert jax.device_count() >= w
    return make_ray_mesh(w)


def _jax_grads(setup, w, kind, rgb_only=False):
    """Gradients of the shard_map'd objective over w shards (no
    perturbation), cached per (w, kind, rgb_only); w = 1: the single-chip
    objective."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pvd_tpu.engine.train_steps import distill_loss, teacher_loss

    cache = setup.setdefault("jax", {})
    key = (w, kind, rgb_only)
    if key in cache:
        return cache[key]
    if kind == "teacher":
        s = setup["st"]
        inp = setup["payload"]["inputs"]["teacher"]
        pix = s["image"][inp["inds"]]
        bg = inp["bg"]
        gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
        cfg = dataclasses.replace(s["cfg_j"], samples_per_ray=0.0)
        rspec = cfg.render_spec()
        params = jax.tree_util.tree_map(jnp.asarray, s["tree"])

        def loss(p, o, d, g, b):
            return teacher_loss(p, s["spec_j"], rspec, cfg, s["occ_j"], o, d,
                                g, b, None)[0]
        extra = (gt, bg)
    else:
        s = setup["sd"]
        inp = setup["payload"]["inputs"]["distill"]
        cfg = s["cfg_j"]
        if rgb_only:
            cfg = dataclasses.replace(cfg, **RGB_ONLY)
        params = jax.tree_util.tree_map(jnp.asarray, s["stu"])
        tea = jax.tree_util.tree_map(jnp.asarray, s["tea"])

        def loss(p, o, d, b):
            return distill_loss(p, tea, s["spec_sj"], s["spec_tj"],
                                s["rspec_j"], cfg, 3, s["occ_j"], s["occ_j"],
                                o, d, b, None, jnp.int32(7))[0]
        extra = (inp["bg"],)
    args = (jnp.asarray(inp["o"]), jnp.asarray(inp["d"])) + tuple(
        jnp.asarray(a) for a in extra)
    if w == 1:
        g = jax.jit(jax.grad(loss))(params, *args)
    else:
        smap = jax.shard_map(
            lambda p, *a: jax.lax.pmean(loss(p, *a), "rays"), mesh=_mesh(w),
            in_specs=(P(),) + (P("rays"),) * len(args), out_specs=P(),
            check_vma=False)
        g = jax.jit(jax.grad(lambda p, *a: smap(p, *a)))(params, *args)
    cache[key] = jax.tree_util.tree_map(np.asarray, g)
    return cache[key]


def _leaves(tree):
    import jax

    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_grads(got, want):
    import jax

    for (path, w), g in zip(_leaves(want), jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=GRAD_REL_ATOL * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))


def _assert_params(got, want, grads):
    """Params after the step, where the gradient is clear of rounding
    noise (> 1e-3 of the leaf's max) or exactly 0."""
    import jax

    n_held = 0
    for (path, w), g, gw in zip(_leaves(want), jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(grads)):
        w, g, gw = np.asarray(w), np.asarray(g), np.abs(np.asarray(gw))
        hold = (gw > MASK_FRAC * gw.max()) | (gw == 0)
        n_held += int(hold.sum())
        np.testing.assert_allclose(g[hold], w[hold], rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert n_held > 0


def _assert_row(got, want, old):
    assert not np.array_equal(got, old)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * float(np.abs(want).max()))


# ---- the tests ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["teacher", "distill"])
def test_dp_grads_match_jax_shard_map(setup, world, kind):
    w, ranks = world
    want = _jax_grads(setup, w, kind)
    for r in ranks:
        _assert_grads(r[kind]["grads"], want)


def test_dp_rgb_only_grads_match_jax(setup, world):
    """The rgb-only stage-3 objective: the per-ray mean splits exactly,
    so the averaged shard gradients match JAX's shard_map and its
    single-chip gradient (tests/test_parallel.py:142-150's tolerance)."""
    w, ranks = world
    shard = _jax_grads(setup, w, "distill", rgb_only=True)
    whole = _jax_grads(setup, 1, "distill", rgb_only=True)
    import jax

    for r in ranks:
        got = r["distill_rgb"]["grads"]
        _assert_grads(got, shard)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(whole)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("kind", ["teacher", "distill_rgb"])
def test_dp_step_equals_single_process_step(setup, world, single, kind):
    """The DP step over the shards against the single-process step on
    their concatenation: metrics, gradients, params and the map row
    updated from the gathered cells and per-ray losses."""
    w, ranks = world
    want = single[kind]
    old = setup["payload"]["teacher" if kind == "teacher"
                           else "distill"]["row"]
    for r in ranks:
        got = r[kind]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            if k in SHARD_LOGS and kind != "teacher":
                continue
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL,
                                       err_msg=k)
        _assert_grads(got["grads"], want["grads"])
        _assert_params(got["params"], want["params"], want["grads"])
        _assert_row(got["row"], want["row"], old)


@pytest.mark.parametrize("kind", ["sweep_full", "sweep_partial"])
def test_dp_sweep_equals_single_process(world, single, kind):
    w, ranks = world
    want = single[kind]
    for r in ranks:
        np.testing.assert_allclose(r[kind]["grid"], want["grid"], rtol=1e-6,
                                   atol=1e-6)
        assert np.array_equal(r[kind]["bits"], want["bits"])
        np.testing.assert_allclose(r[kind]["mean"], want["mean"], rtol=1e-6)
    assert want["bits"].any() and not want["bits"].all()


def test_dp_eval_image_equals_single_process(world, single):
    w, ranks = world
    want = single["eval"]
    assert want["rungs"] > 1  # the ladder stepped up
    for r in ranks:
        for k in ("image", "depth", "ws"):
            np.testing.assert_allclose(r["eval"][k], want[k], rtol=0,
                                       atol=1e-6, err_msg=k)
        assert r["eval"]["trunc"] == want["trunc"] == 0
    assert want["ws"].max() > 0.5


def test_dp_scan_equals_single_dp_steps(world):
    w, ranks = world
    assert all(r["scan"]["same"] for r in ranks)


def test_replicas_stay_equal(world):
    """Every rank's params and map after the DP chunk, and after the
    Trainer runs its params, occupancy and map, bit for bit."""
    w, ranks = world
    first = ranks[0]
    for r in ranks[1:]:
        assert np.array_equal(r["scan"]["map"], first["scan"]["map"])
        for a, b in zip(_flat(r["scan"]["params"]),
                        _flat(first["scan"]["params"])):
            assert np.array_equal(a, b)
        if "trainer" in r:
            t, t0 = r["trainer"], first["trainer"]
            for k in ("tea_params", "stu_params"):
                for a, b in zip(t[k], t0[k]):
                    assert np.array_equal(a, b), k
            assert np.array_equal(t["tea_occ"], t0["tea_occ"])
            assert np.array_equal(t["tea_map"], t0["tea_map"])
            assert (t["tea_map"] != 1.0).any()


def test_trainer_dp_improves_psnr(setup, tmp_path_factory):
    """Two ranks: the teacher (error map, scan steps of 2) and its
    student (scan steps of 4) raise their batch PSNR; the config rounds
    num_rays up to the world and forces preload; the CLI trains and
    evaluates; n_devices against the world size raises."""
    if 2 not in setup["ranks"]:
        tmp = str(tmp_path_factory.mktemp("dp2"))
        setup["ranks"][2] = _run_world(2, tmp, setup["payload"])
    for r in setup["ranks"][2]:
        t = r["trainer"]
        assert t["tea_cfg"] == (126, True)
        tea, stu = t["tea_psnr"], t["stu_psnr"]
        assert len(tea) == 48 and np.isfinite(tea).all()
        assert np.mean(tea[-8:]) > np.mean(tea[:8]) + 2.0, tea
        assert np.mean(stu[-8:]) > np.mean(stu[:8]) + 1.0, stu
        assert t["tea_eval"] > 10.0 and np.isfinite(t["cli_psnr"])
        assert "world size is 2" in t["wrong_world"], t["wrong_world"]
    # the CLI's workspace, renamed with its PSNR by rank 0 alone
    tmp = setup["ranks"][2][0]["tmp"]
    done = [f for f in os.listdir(tmp) if f.startswith("cli")]
    assert len(done) == 1 and done[0].startswith("cli-psnr"), done
    ws = os.path.join(tmp, done[0])
    assert {"metrics.json", "args.json", "checkpoints", "results"} <= set(
        os.listdir(ws))


def test_rank_seed_gives_every_rank_its_own_stream():
    """Every rank's stream, rank 0's included, is seeded apart from the
    shared one (`seed`) and from every other rank's, the same in every
    process."""
    from pvd_tpu_torch.parallel.mesh import rank_seed
    for seed in (0, 1, 2 ** 31):
        seeds = [rank_seed(seed, r) for r in range(8)]
        assert len(set(seeds)) == 8 and seed not in seeds
        assert seeds == [rank_seed(seed, r) for r in range(8)]
        assert all(0 <= x < 2 ** 63 for x in seeds)
