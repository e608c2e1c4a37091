"""Host-side training orchestrator (port of pvd_tpu/engine/trainer.py).

Teacher mode only, on one device, with preloaded images and single steps
(trainer.py:60-150, 417-470, 618-1008):

  mark_untrained_grid -> per step: autotune tick, occupancy refresh every
  `update_extra_interval` steps (full sweeps while fewer than 16 updates
  have run, then partial), one teacher step on a random training image.

The first 16 x update_extra_interval steps render uncompacted (the padded
[N, S] path) while the fresh grid converges; at the first autotune tick
after them the sample budget turns on and `retune` buckets it from the
live statistics, as the JAX Trainer does.

Distill mode, checkpoints, `evaluate`, EMA, the error map, scan steps,
data parallelism, the host batcher, VM resizing and the wall budget are not
ported yet (ROADMAP A10, A11, A15-A17) and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.engine.autotune import retune
from pvd_tpu_torch.engine.optim import build_optimizer, exp_decay_schedule
from pvd_tpu_torch.engine.train_steps import (TrainState, make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step)
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.models.hash_field import HashField
from pvd_tpu_torch.render.occupancy import (draw_occ_inputs,
                                            init_occupancy_state,
                                            mark_untrained_grid)


def _unported(what: str, item: str):
    raise NotImplementedError(f"Trainer: {what} is not ported yet "
                              f"(ROADMAP {item})")


def _check_cfg(cfg: PVDConfig):
    checks = (
        (cfg.model_type != "hash", f"model_type {cfg.model_type!r} as a "
         "teacher", "A12"),
        (cfg.ema_decay > 0, "EMA (ema_decay > 0)", "A16"),
        (cfg.error_map, "the error map", "A16"),
        (cfg.scan_steps > 1, "scan steps", "A16"),
        (cfg.n_devices != 1, "data parallelism (n_devices != 1)", "A17"),
        (not cfg.preload, "the host batcher (preload=False)", "A15"),
        (bool(cfg.upsample_model_steps), "VM resizing", "A12"),
        (cfg.wall_budget > 0, "the wall budget", "A10"),
        (cfg.bg_radius > 0, "the background model (bg_radius > 0)", "A12"),
    )
    for bad, what, item in checks:
        if bad:
            _unported(what, item)


class Trainer:
    """Trains one hash (INGP) teacher on a dataset split.

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  The field's initial weights come from `cfg.seed`; the steps'
    and occupancy updates' draws from a `torch.Generator` seeded with
    `cfg.seed + 1`; the image order from `np.random.default_rng(cfg.seed)`
    (the JAX Trainer's host draw).
    """

    def __init__(self, cfg: PVDConfig, mode: str = "teacher",
                 name: Optional[str] = None, device="cuda"):
        if mode != "teacher":
            _unported(f"mode {mode!r}", "A10")
        _check_cfg(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name or cfg.model_type
        self.rspec = cfg.render_spec()
        self.spec = cfg.model_spec(cfg.model_type)
        devices = ([torch.cuda.current_device()]
                   if self.device.type == "cuda" else [])
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(cfg.seed)
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            field = HashField(self.spec, device=self.device, generator=gen)
        # learning rates of the teacher (trainer.py:87-103): lr on the main
        # group, 0.1 * lr on head_lr2, both decaying 0.1^(step / iters)
        params = dict(field.named_parameters())
        self.opt = build_optimizer(
            params, param_group_label(self.spec),
            trainable_label(self.spec, ""),
            exp_decay_schedule(cfg.lr, cfg.iters),
            exp_decay_schedule(cfg.lr * 0.1, cfg.iters))
        self.state = TrainState(
            field=field, opt_state=self.opt.init(params),
            occ=init_occupancy_state(self.rspec, self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self._steps = {}
        self._warmup_spr = 0.0
        self._autotune_cooldown = 0
        self._last_metrics = None
        self.history = []  # per-step metrics (0-d tensors on the device)
        self.train_stats = {}
        self._rebuild_renderers()

    def log(self, msg: str):
        print(msg, flush=True)

    def evaluate(self, *args, **kwargs):
        _unported("evaluate (PSNR/SSIM/LPIPS, images, video)", "A11")

    def save(self, *args, **kwargs):
        _unported("checkpoints", "A10")

    load_teacher = load_student = try_resume = save

    # ------------------------------------------------------------------
    def _rebuild_renderers(self):
        self._occ_update = make_occ_update(self.spec, self.rspec,
                                           device=self.device)
        self.eval_render = make_eval_renderer(
            self.spec, self.rspec, chunk=self.cfg.max_ray_batch,
            device=self.device)

    def _get_step_fn(self, H: int, W: int, C: int, intr):
        key = (H, W, C)
        if key not in self._steps:
            self._steps[key] = make_teacher_step(
                self.spec, self.rspec, self.opt, self.cfg, intr, H, W,
                image_channels=C, device=self.device)
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

    # ------------------------------------------------------------------
    def train(self, train_ds, valid_ds=None, max_steps: Optional[int] = None):
        """Train on `train_ds` (poses [B, 4, 4] NGP, `images_flat()`
        [B, H*W, C], intrinsics, H, W) for `max_steps` or `cfg.iters`
        steps.  Returns the state; `train_stats` holds the step count,
        wall and occupancy seconds, rays/s, and the host-clock ms per step
        of the padded and compacted phases and per full and partial
        occupancy update (the clock is synchronised at every occupancy
        tick)."""
        if valid_ds is not None:
            _unported("mid-training eval", "A11")
        cfg = self.cfg
        total = max_steps or cfg.iters
        H, W = train_ds.H, train_ds.W
        intr = tuple(float(v) for v in train_ds.intrinsics)
        rng_np = np.random.default_rng(cfg.seed)

        # the grid's warmup runs uncompacted: a budget sized for the
        # converged grid would starve most rays of the fresh, mostly
        # occupied one (trainer.py:627-639)
        if (cfg.autotune_budget and self.rspec.samples_per_ray > 0
                and self.state.step < 16 * cfg.update_extra_interval):
            self._warmup_spr = self.rspec.samples_per_ray
            self.rspec = dataclasses.replace(self.rspec, samples_per_ray=0.0)
            self._steps.clear()
            self._rebuild_renderers()

        self.state.occ = mark_untrained_grid(self.state.occ, train_ds.poses,
                                             intr, self.rspec)
        poses = torch.as_tensor(train_ds.poses, dtype=torch.float32,
                                device=self.device)
        images = torch.as_tensor(train_ds.images_flat(), dtype=torch.float32,
                                 device=self.device)
        C = int(images.shape[-1])

        # host clock, synchronised at every occupancy tick: the step time
        # of each phase (padded, compacted) and the occupancy updates'
        phases = {"padded": [0, 0.0], "compacted": [0, 0.0]}
        occ_s = {"full": [0, 0.0], "partial": [0, 0.0]}
        self._sync()
        t_start = t_tick = time.perf_counter()
        step = step0 = tick_step = self.state.step
        phase = "compacted" if self.rspec.samples_per_ray > 0 else "padded"
        while step < total:
            if step % cfg.update_extra_interval == 0:
                self._sync()
                now = time.perf_counter()
                phases[phase][0] += step - tick_step
                phases[phase][1] += now - t_tick
                self._maybe_autotune(step, self._last_metrics)
                t0 = time.perf_counter()
                kind = "full" if self._update_occ() else "partial"
                self._sync()
                t_tick = time.perf_counter()
                occ_s[kind][0] += 1
                occ_s[kind][1] += t_tick - t0
                tick_step = step
                phase = ("compacted" if self.rspec.samples_per_ray > 0
                         else "padded")
            idx = int(rng_np.integers(0, len(poses)))
            step_fn = self._get_step_fn(H, W, C, intr)
            self.state, metrics = step_fn(self.state, poses[idx],
                                          images[idx], self.generator)
            self._last_metrics = metrics
            self.history.append(metrics)
            if step % 100 == 0:
                msg = " ".join(f"{k}={float(v):.4f}"
                               for k, v in sorted(metrics.items()))
                self.log(f"[{self.name}] step {step}/{total} {msg} "
                         f"({time.perf_counter() - t_start:.1f}s)")
            step += 1
        self._sync()
        now = time.perf_counter()
        phases[phase][0] += step - tick_step
        phases[phase][1] += now - t_tick
        wall = now - t_start
        steps_done = step - step0
        if steps_done:
            t_occ = occ_s["full"][1] + occ_s["partial"][1]
            self.train_stats = {
                "train_steps": steps_done,
                "train_wall_s": wall,
                "train_occ_s": t_occ,
                "train_rays_per_sec": steps_done * cfg.num_rays / wall,
                "train_rays_per_sec_steady":
                    steps_done * cfg.num_rays / max(wall - t_occ, 1e-9),
            }
            for name, (n, secs) in phases.items():
                self.train_stats[f"{name}_steps"] = n
                self.train_stats[f"{name}_ms_per_step"] = \
                    secs / n * 1e3 if n else None
            for kind, (n, secs) in occ_s.items():
                self.train_stats[f"occ_{kind}_updates"] = n
                self.train_stats[f"occ_{kind}_ms"] = \
                    secs / n * 1e3 if n else None
            self.log(f"[{self.name}] e2e throughput: {self.train_stats}")
        return self.state
