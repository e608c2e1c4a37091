"""Host-side training orchestrator (port of pvd_tpu/engine/trainer.py).

One device, preloaded images, single steps, in two modes
(trainer.py:60-277, 417-470, 569-1126):

  mode="teacher": train a hash (INGP) field against the images:
    mark_untrained_grid -> per step: autotune tick, occupancy refresh every
    `update_extra_interval` steps (full sweeps while fewer than 16 updates
    have run, then partial), one teacher step on a random training image.
    The first 16 x update_extra_interval steps render uncompacted (the
    padded [N, S] path) while the fresh grid converges; at the first
    autotune tick after them the sample budget turns on.
  mode="distill": a frozen hash teacher (`load_teacher`, a checkpoint file;
    baked with `hash_bake_dense`, as the JAX package's attach_packed does)
    and a VM student warm-started from the teacher's shared heads; the
    student inherits the teacher's occupancy grid and does not refresh it
    unless `update_stu_extra`; each epoch draws fresh random poses
    (`data/poses.get_rand_poses`); stages 1 -> 2 -> 3 switch at
    `stage1_iters` / `stage2_iters`; cosine learning-rate schedules.

Both modes run in epochs (the training images, or one epoch's random
poses), write step checkpoints over the last two epochs and at the end,
and evaluate `valid_ds` every `eval_interval` epochs and at the end,
keeping `{name}_best.ckpt` by PSNR.  A `wall_budget` ends training early
at an epoch boundary, with the normal final checkpoint and eval.
Checkpoints are the JAX package's format (`engine/checkpoint.py`).
`evaluate` writes each view's PNG and depth PNG (`data/png.py`) and
optionally a video, and reports PSNR, SSIM and the JAX package's LPIPS
proxy.

Both modes take the large-scene settings: bound > 1 (two or more
occupancy cascades), the geometric march (dt_gamma > 0) and the background
model (bg_radius > 0), which both fields then own and train.

Not ported yet, and raising NotImplementedError with their ROADMAP item:
EMA, the error map, scan steps, data parallelism, the host batcher, VM
resizing, teachers other than hash and students other than VM (ROADMAP
A12-A17).  Real LPIPS needs pretrained weights that neither machine has;
like the JAX package without them, `evaluate` reports the proxy.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.png import write_png
from pvd_tpu_torch.data.poses import get_rand_poses, rand_orbit_poses
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.autotune import retune
from pvd_tpu_torch.engine.optim import (build_optimizer, cosine_schedule,
                                        exp_decay_schedule)
from pvd_tpu_torch.engine.train_steps import (TrainState, make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step)
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.models.vm_field import VMField
from pvd_tpu_torch.params import field_from_tree, tree_from_field
from pvd_tpu_torch.render.occupancy import (draw_occ_inputs,
                                            init_occupancy_state,
                                            mark_untrained_grid)
from pvd_tpu_torch.utils.metrics import PSNRMeter, compute_ssim, lpips_proxy

MODES = ("teacher", "distill")


def _unported(what: str, item: str):
    raise NotImplementedError(f"Trainer: {what} is not ported yet "
                              f"(ROADMAP {item})")


def _check_cfg(cfg: PVDConfig, mode: str):
    if mode == "teacher":
        roles = ((cfg.model_type != "hash", f"model_type {cfg.model_type!r} "
                  "as a teacher", "A12"),
                 (not cfg.preload, "the host batcher (preload=False)", "A15"))
    else:
        roles = ((cfg.teacher_type != "hash", f"teacher_type "
                  f"{cfg.teacher_type!r}", "A12"),
                 (cfg.model_type != "vm", f"a {cfg.model_type!r} student "
                  "(only vm)", "A12"))
    checks = roles + (
        (cfg.ema_decay > 0, "EMA (ema_decay > 0)", "A16"),
        (cfg.error_map, "the error map", "A16"),
        (cfg.scan_steps > 1, "scan steps", "A16"),
        (cfg.n_devices != 1, "data parallelism (n_devices != 1)", "A17"),
        (bool(cfg.upsample_model_steps), "VM resizing", "A12"),
    )
    for bad, what, item in checks:
        if bad:
            _unported(what, item)


def _new_field(spec, device, gen):
    return (HashField if spec.model_type == "hash" else VMField)(
        spec, device=device, generator=gen)


class _PhaseClock:
    """Host clock of the steps, per phase: each window of steps ends in a
    synchronize, and work between windows (occupancy updates, evals,
    checkpoints) is left out."""

    def __init__(self, sync, phases, phase: str, step: int):
        self.sync = sync
        self.acc = {p: [0, 0.0] for p in phases}
        self.phase, self.step = phase, step
        self.t = time.perf_counter()

    def mark(self, step: int):
        """Close the window at `step`, charging it to the current phase."""
        self.sync()
        now = time.perf_counter()
        self.acc[self.phase][0] += step - self.step
        self.acc[self.phase][1] += now - self.t
        self.step, self.t = step, now

    def restart(self):
        """Open the next window now (after work that is not a step)."""
        self.sync()
        self.t = time.perf_counter()


class Trainer:
    """Trains a hash teacher (mode "teacher") or distills a frozen hash
    teacher into a VM student (mode "distill").

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  The trained field's initial weights come from `cfg.seed`; the
    steps' and occupancy updates' draws from a `torch.Generator` seeded
    with `cfg.seed + 1`; the image order and the distillation poses from
    `np.random.default_rng(cfg.seed)` (the JAX Trainer's host draws).
    """

    def __init__(self, cfg: PVDConfig, mode: str = "teacher",
                 name: Optional[str] = None, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        _check_cfg(cfg, mode)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.name = name or (cfg.model_type if mode == "teacher"
                             else f"{cfg.teacher_type}2{cfg.model_type}")
        self.workspace = cfg.workspace
        self.rspec = cfg.render_spec()
        self.spec_stu = cfg.model_spec(cfg.model_type)
        self.spec_tea = cfg.model_spec(cfg.teacher_type)
        devices = ([torch.cuda.current_device()]
                   if self.device.type == "cuda" else [])
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(cfg.seed)
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            field = _new_field(self.spec_stu, self.device, gen)
            # distill: a random teacher until load_teacher, as in the JAX
            # package
            self.teacher = (_new_field(self.spec_tea, self.device, gen)
                            .requires_grad_(False)
                            if mode == "distill" else None)
        self.occ_tea = (init_occupancy_state(self.rspec, self.device)
                        if mode == "distill" else None)
        # learning rates (trainer.py:87-103): the reference's x0.1 for the
        # mlp field; the teacher's second group at 0.1 * lr, the distill
        # student's at 1e-3; exponential decay for a teacher, cosine
        # annealing for a student
        base_lr = cfg.lr * (0.1 if cfg.model_type == "mlp" else 1.0)
        if mode == "teacher":
            lr2, sched = base_lr * 0.1, exp_decay_schedule
        else:
            lr2, sched = 1e-3, cosine_schedule
        params = dict(field.named_parameters())
        self.opt = build_optimizer(
            params, param_group_label(self.spec_stu),
            trainable_label(self.spec_stu,
                            cfg.distill_mode if mode == "distill" else ""),
            sched(base_lr, cfg.iters), sched(lr2, cfg.iters))
        self.state = TrainState(
            field=field, opt_state=self.opt.init(params),
            occ=init_occupancy_state(self.rspec, self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self._steps = {}
        self._warmup_spr = 0.0
        self._autotune_cooldown = 0
        self._last_metrics = None
        self.best_psnr = -1.0
        self.history = []  # per-step metrics (0-d tensors on the device)
        self.train_stats = {}
        self.stats = {}
        self._rebuild_renderers()

    @property
    def spec(self):
        """The trained field's ModelSpec."""
        return self.spec_stu

    def log(self, msg: str):
        print(msg, flush=True)

    # ------------------------------------------------------------------
    def load_teacher(self, path: str):
        """Load a teacher checkpoint (either package's): the teacher
        freezes, the student warm-starts from its heads and inherits its
        occupancy grid (trainer.py:190-222)."""
        payload = ckpt.load_checkpoint(path, self.device)
        got = tuple(payload["occ"].bitfield.shape)
        exp = tuple(self.state.occ.bitfield.shape)
        if got != exp:
            raise ValueError(
                f"teacher occupancy grid {got} != this run's {exp}: the "
                "student inherits the teacher's grid verbatim, so grid_size"
                " and bound must match the teacher's training settings")
        self.teacher = field_from_tree(payload["params"], self.spec_tea,
                                       self.device).requires_grad_(False)
        if self.spec_tea.model_type == "hash":
            # frozen: bake the dense levels once (attach_packed)
            self.teacher.bake()
        self.occ_tea = payload["occ"]
        tree = ckpt.warm_start_student(tree_from_field(self.state.field),
                                       payload["params"])
        field = field_from_tree(tree, self.spec_stu, self.device)
        self.state = TrainState(
            field=field, opt_state=self.opt.init(dict(
                field.named_parameters())),
            occ=payload["occ"], step=self.state.step)
        self.log(f"[load_teacher] {path} (step {payload['step']})")

    def load_student(self, path: str):
        """Resume the trained field, its grid and its step from a
        checkpoint; the optimizer starts afresh (trainer.py:224-246)."""
        payload = ckpt.load_checkpoint(path, self.device)
        params = payload["params"]
        if self.spec_stu.model_type == "vm":
            # the live resolution from the loaded plane and line shapes
            # (trainer.py:240-245)
            m0, v0 = params["sigma_mat"][0], params["sigma_vec"][0]
            res = (m0.shape[1], m0.shape[0], v0.shape[0])
            if res != tuple(self.spec_stu.vm_resolution):
                self.spec_stu = dataclasses.replace(self.spec_stu,
                                                    vm_resolution=res)
                self._steps.clear()
                self._rebuild_renderers()
        field = field_from_tree(params, self.spec_stu, self.device)
        self.state = TrainState(
            field=field, opt_state=self.opt.init(dict(
                field.named_parameters())),
            occ=payload["occ"], step=payload["step"])
        self.log(f"[load_student] {path} (step {payload['step']})")

    def _ckpt_dir(self) -> str:
        return os.path.join(self.workspace, "checkpoints")

    def save(self, stats: Optional[dict] = None,
             filename: Optional[str] = None) -> str:
        """A checkpoint of the trained field (trainer.py:248-258)."""
        return ckpt.save_checkpoint(
            self._ckpt_dir(), self.name, self.state.step,
            tree_from_field(self.state.field), self.state.occ,
            stats=stats or self.stats, config_json=self.cfg.to_json(),
            filename=filename)

    def try_resume(self) -> bool:
        path = ckpt.latest_checkpoint(self._ckpt_dir(), self.name)
        if path:
            self.load_student(path)
            return True
        return False

    # ------------------------------------------------------------------
    def _stage_of(self, step: int) -> int:
        if self.mode != "distill":
            return 3
        if step < self.cfg.stage1_iters:
            return 1
        if step < self.cfg.stage2_iters:
            return 2
        return 3

    def _phase(self, step: int) -> str:
        if self.mode == "distill":
            return f"stage{self._stage_of(step)}"
        return "compacted" if self.rspec.samples_per_ray > 0 else "padded"

    def _rebuild_renderers(self):
        self._occ_update = make_occ_update(self.spec_stu, self.rspec,
                                           device=self.device)
        self.eval_render = make_eval_renderer(
            self.spec_stu, self.rspec, chunk=self.cfg.max_ray_batch,
            device=self.device)
        self.eval_render_tea = (make_eval_renderer(
            self.spec_tea, self.rspec, chunk=self.cfg.max_ray_batch,
            device=self.device) if self.mode == "distill" else None)

    def _get_step_fn(self, stage: int, H: int, W: int, C: int, intr):
        key = (stage, H, W, C)
        if key not in self._steps:
            if self.mode == "teacher":
                self._steps[key] = make_teacher_step(
                    self.spec_stu, self.rspec, self.opt, self.cfg, intr, H,
                    W, image_channels=C, device=self.device)
            else:
                self._steps[key] = make_distill_step(
                    self.spec_stu, self.spec_tea, self.rspec, self.opt,
                    self.cfg, intr, H, W, stage, device=self.device)
        return self._steps[key]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _update_occ(self) -> bool:
        """One occupancy update: full sweeps while fewer than 16 updates
        have run, then partial (trainer.py:417-422).  Returns `full`."""
        occ = self.state.occ
        full = occ.iter_density < 16
        jitter, coords = draw_occ_inputs(self.generator, occ, self.rspec,
                                         full)
        self.state.occ = self._occ_update(occ, self.state.field, full=full,
                                          jitter=jitter, coords=coords)
        return full

    def _maybe_autotune(self, step: int, metrics: Optional[dict]):
        """Adapt S_max and the sample budget to the measured occupancy
        statistics; called at each occupancy tick (trainer.py:424-467)."""
        cfg = self.cfg
        if not cfg.autotune_budget or metrics is None:
            return
        # the first 16 updates are full sweeps of a mostly-occupied fresh
        # grid: statistics from then say nothing about the converged grid
        if step < 16 * cfg.update_extra_interval:
            return
        if self._warmup_spr:
            spr, self._warmup_spr = self._warmup_spr, 0.0
            self.rspec = dataclasses.replace(self.rspec, samples_per_ray=spr)
            self._steps.clear()
            self._rebuild_renderers()
            self.log(f"[autotune] warmup over: sample budget on ({spr}/ray "
                     "before bucketing)")
        rs = self.rspec
        budget_hit = float(metrics["budget_hit"])
        mask_frac = float(metrics["mask_frac"])
        cooldown = self._autotune_cooldown  # shrink freeze after escalation
        new_rs = retune(rs, budget_hit, mask_frac, allow_shrink=cooldown == 0)
        self._autotune_cooldown = max(0, cooldown - 1)
        if new_rs is not None:
            if new_rs.max_samples > rs.max_samples:
                self._autotune_cooldown = 4
            self.rspec = new_rs
            self._steps.clear()
            self._rebuild_renderers()
            self.log(f"[autotune] S_max {rs.max_samples}->"
                     f"{new_rs.max_samples} budget/ray {rs.samples_per_ray}"
                     f"->{new_rs.samples_per_ray} "
                     f"(budget_hit={budget_hit:.3f} mask_frac={mask_frac:.3f})")

    def _distill_epoch_poses(self, rng_np, train_ds) -> np.ndarray:
        """Fresh random viewpoints for one distillation epoch, plus the
        optional `rand_pose` orbit cameras (trainer.py:569-590): 0 = orbit
        poses only, > 0 = one orbit pose per `rand_pose` poses."""
        cfg = self.cfg
        poses = get_rand_poses(rng_np, cfg.data_type, train_ds.poses)
        if cfg.rand_pose == 0:
            return rand_orbit_poses(rng_np, len(poses), radius=3.2)
        if cfg.rand_pose > 0:
            extra = rand_orbit_poses(
                rng_np, max(1, len(poses) // cfg.rand_pose), radius=3.2)
            poses = np.concatenate([poses, extra], axis=0)
        return poses

    def _eval_and_track_best(self, valid_ds) -> dict:
        """Evaluate `valid_ds`; a new best PSNR writes `{name}_best.ckpt`
        (trainer.py:592-616)."""
        stats = self.evaluate(valid_ds)
        psnr = stats.get("psnr", 0.0)
        if psnr > self.best_psnr:
            self.best_psnr = psnr
            path = self.save(stats=stats, filename=f"{self.name}_best.ckpt")
            self.log(f"[best] psnr={psnr:.2f} -> {path}")
        return stats

    # ------------------------------------------------------------------
    def train(self, train_ds, valid_ds=None, max_steps: Optional[int] = None):
        """Train on `train_ds` (poses [B, 4, 4] NGP, `images_flat()`
        [B, H*W, C], intrinsics, H, W) for `max_steps` or `cfg.iters`
        steps; distill mode renders at train_ds's H, W and intrinsics from
        random poses and reads no images.  Returns the state.

        `train_stats` holds the step count, wall, occupancy, eval and
        checkpoint seconds, rays/s, and the host-clock ms per step of each
        phase (teacher: padded and compacted; distill: stage1-3) and per
        full and partial occupancy update."""
        cfg = self.cfg
        total = max_steps or cfg.iters
        H, W = train_ds.H, train_ds.W
        intr = tuple(float(v) for v in train_ds.intrinsics)
        rng_np = np.random.default_rng(cfg.seed)
        teacher_mode = self.mode == "teacher"

        # the grid's warmup runs uncompacted: a budget sized for the
        # converged grid would starve most rays of the fresh, mostly
        # occupied one (trainer.py:627-639)
        if (teacher_mode and cfg.autotune_budget
                and self.rspec.samples_per_ray > 0
                and self.state.step < 16 * cfg.update_extra_interval):
            self._warmup_spr = self.rspec.samples_per_ray
            self.rspec = dataclasses.replace(self.rspec, samples_per_ray=0.0)
            self._steps.clear()
            self._rebuild_renderers()

        def as_dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        if teacher_mode:
            self.state.occ = mark_untrained_grid(
                self.state.occ, train_ds.poses, intr, self.rspec)
            poses = as_dev(train_ds.poses)
            images = as_dev(train_ds.images_flat())
            C = int(images.shape[-1])
            phases = ("padded", "compacted")
        else:
            poses = as_dev(self._distill_epoch_poses(rng_np, train_ds))
            C = 4
            phases = ("stage1", "stage2", "stage3")
        refresh_occ = teacher_mode or cfg.update_stu_extra

        occ_s = {"full": [0, 0.0], "partial": [0, 0.0]}
        side_s = {"eval": 0.0, "ckpt": 0.0}
        self._sync()
        t_start = time.perf_counter()
        step = step0 = self.state.step
        clock = _PhaseClock(self._sync, phases, self._phase(step), step)
        epoch_len = len(poses)
        epoch = step // max(epoch_len, 1)
        while step < total:
            epoch += 1
            # fresh random poses per distillation epoch
            if not teacher_mode and step > 0:
                poses = as_dev(self._distill_epoch_poses(rng_np, train_ds))
                epoch_len = len(poses)
            for _ in range(min(epoch_len, total - step)):
                if step % cfg.update_extra_interval == 0:
                    clock.mark(step)
                    self._maybe_autotune(step, self._last_metrics)
                    if refresh_occ:
                        t0 = time.perf_counter()
                        kind = "full" if self._update_occ() else "partial"
                        self._sync()
                        occ_s[kind][0] += 1
                        occ_s[kind][1] += time.perf_counter() - t0
                    clock.restart()
                phase = self._phase(step)
                if phase != clock.phase:
                    clock.mark(step)
                    clock.phase = phase
                idx = int(rng_np.integers(0, len(poses)))
                stage = self._stage_of(step)
                step_fn = self._get_step_fn(stage, H, W, C, intr)
                if teacher_mode:
                    self.state, metrics = step_fn(self.state, poses[idx],
                                                  images[idx], self.generator)
                else:
                    self.state, metrics = step_fn(self.state, self.teacher,
                                                  self.occ_tea, poses[idx],
                                                  self.generator)
                self._last_metrics = metrics
                self.history.append(metrics)
                if step % 100 == 0:
                    msg = " ".join(f"{k}={float(v):.4f}"
                                   for k, v in sorted(metrics.items()))
                    self.log(f"[{self.name}] step {step}/{total} stage{stage}"
                             f" {msg} ({time.perf_counter() - t_start:.1f}s)")
                step += 1

            # a spent wall budget makes this epoch boundary the end of
            # training, with the final checkpoint and eval (trainer.py:
            # 962-973)
            if (cfg.wall_budget > 0 and step < total
                    and time.perf_counter() - t_start >= cfg.wall_budget):
                self.log(f"[{self.name}] wall budget ({cfg.wall_budget:.0f}"
                         f"s) spent at step {step}/{total}; finishing early")
                total = step
            # epoch boundary: step checkpoints over the last two epochs,
            # then the periodic eval with best tracking (trainer.py:973-983)
            clock.mark(step)
            if step >= total - 2 * epoch_len:
                t0 = time.perf_counter()
                self.save()
                side_s["ckpt"] += time.perf_counter() - t0
            if valid_ds is not None and (epoch % cfg.eval_interval == 0
                                         or step >= total):
                t0 = time.perf_counter()
                self._eval_and_track_best(valid_ds)
                side_s["eval"] += time.perf_counter() - t0
            clock.restart()

        self._sync()
        wall = time.perf_counter() - t_start
        steps_done = step - step0
        if steps_done:
            t_occ = occ_s["full"][1] + occ_s["partial"][1]
            steady = max(wall - t_occ - side_s["eval"] - side_s["ckpt"], 1e-9)
            self.train_stats = {
                "train_steps": steps_done,
                "train_wall_s": wall,
                "train_occ_s": t_occ,
                "train_eval_s": side_s["eval"],
                "train_ckpt_s": side_s["ckpt"],
                "train_rays_per_sec": steps_done * cfg.num_rays / wall,
                "train_rays_per_sec_steady": steps_done * cfg.num_rays
                / steady,
            }
            for name, (n, secs) in clock.acc.items():
                self.train_stats[f"{name}_steps"] = n
                self.train_stats[f"{name}_ms_per_step"] = \
                    secs / n * 1e3 if n else None
            for kind, (n, secs) in occ_s.items():
                self.train_stats[f"occ_{kind}_updates"] = n
                self.train_stats[f"occ_{kind}_ms"] = \
                    secs / n * 1e3 if n else None
            self.log(f"[{self.name}] e2e throughput: {self.train_stats}")
        self.save()
        return self.state

    # ------------------------------------------------------------------
    def _write_video(self, path: str, frames, fps: int = 21):
        """An mp4 through imageio when it has a codec, as the JAX package
        writes it (trainer.py:990-1008, fps 21); else the JAX package's
        log line."""
        try:
            import imageio

            imageio.mimwrite(path, np.stack(frames), fps=fps, quality=8)
        except Exception:
            self.log(f"[evaluate] video write skipped (no codec): {path}")
            return
        self.log(f"[evaluate] wrote {path}")

    @torch.no_grad()
    def evaluate(self, ds, use_teacher: bool = False,
                 save_dir: Optional[str] = None, write_video: bool = False,
                 refresh_occ: bool = False) -> dict:
        """Full-image eval of `ds` (trainer.py:1010-1126): PSNR, SSIM and
        the LPIPS proxy against the GT composited on white, and the render
        seconds per image (`eval_s_per_image`, the minimum over images, and
        `eval_s_first_image`).  `use_teacher` renders the distill teacher.

        Writes `{name}_{i:04d}.png` and `{name}_{i:04d}_depth.png` per view
        into `save_dir` (default `<workspace>/results`) and, with
        `write_video`, `{name}_video.mp4` and `{name}_video_depth.mp4`.
        `refresh_occ` first runs one full occupancy update of the trained
        field from its current params (its jitter drawn from a generator
        seeded 0, as the JAX package draws it from PRNGKey(0))."""
        if refresh_occ and not use_teacher:
            gen = torch.Generator(device=self.device).manual_seed(0)
            jitter, coords = draw_occ_inputs(gen, self.state.occ, self.rspec,
                                             True)
            self.state.occ = self._occ_update(
                self.state.occ, self.state.field, full=True, jitter=jitter,
                coords=coords)
        if use_teacher:
            field, occ, render = self.teacher, self.occ_tea, \
                self.eval_render_tea
        else:
            field, occ, render = self.state.field, self.state.occ, \
                self.eval_render
        save_dir = save_dir or os.path.join(self.workspace, "results")
        os.makedirs(save_dir, exist_ok=True)
        meter, ssims, lp, times = PSNRMeter(), [], [], []
        frames, depth_frames = [], []
        for i in range(len(ds)):
            self._sync()
            t0 = time.perf_counter()
            out = render(field, occ, ds.poses[i], ds.intrinsics, ds.H, ds.W)
            img = out.image.cpu().numpy()
            dep = out.depth.cpu().numpy()
            times.append(time.perf_counter() - t0)
            if ds.images is not None:
                gt = ds.images[i]
                if gt.shape[-1] == 4:
                    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
                meter.update(img, gt)
                ssims.append(compute_ssim(img, gt))
                lp.append(lpips_proxy(img, gt))
            u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            d8 = (np.clip(dep, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(save_dir, f"{self.name}_{i:04d}.png"), u8)
            write_png(os.path.join(save_dir,
                                   f"{self.name}_{i:04d}_depth.png"), d8)
            frames.append(u8)
            depth_frames.append(d8)
        if write_video and frames:
            self._write_video(
                os.path.join(save_dir, f"{self.name}_video.mp4"), frames)
            self._write_video(
                os.path.join(save_dir, f"{self.name}_video_depth.mp4"),
                [np.repeat(f[..., None], 3, axis=-1) for f in depth_frames])
        stats = {"psnr": meter.measure(),
                 "ssim": float(np.mean(ssims)) if ssims else 0.0}
        if times:
            stats["eval_s_per_image"] = min(times)
            stats["eval_s_first_image"] = times[0]
        stats.update(self.train_stats)
        if lp:
            # random-feature proxy, comparable only with itself
            stats["lpips_proxy"] = float(np.mean(lp))
        self.stats = stats
        self.log(f"[evaluate:{self.name}] {stats}")
        return stats
