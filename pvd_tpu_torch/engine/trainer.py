"""Host-side training orchestrator (port of pvd_tpu/engine/trainer.py).

Any of the four fields (hash, mlp, vm, tensors) as teacher or student,
on one device or data parallel over several, in single steps or chunks
of K steps, in two modes (trainer.py:60-277, 417-470, 569-1126):

  mode="teacher": train a field against the images:
    mark_untrained_grid -> per step: autotune tick, occupancy refresh every
    `update_extra_interval` steps (full sweeps while fewer than 16 updates
    have run, then partial), one teacher step on a training image: with
    `preload` a random image resident on the device, else a batch of the
    host batcher (`data/raybatch.RayBatcher`: image, pixel ids and GT
    pixels drawn on the host and copied over, trainer.py:656-668).
    The first 16 x update_extra_interval steps render uncompacted (the
    padded [N, S] path) while the fresh grid converges; at the first
    autotune tick after them the sample budget turns on.
  mode="distill": a frozen teacher (`load_teacher`, a checkpoint file; a
    hash teacher baked with `hash_bake_dense`, as the JAX package's
    attach_packed does) and a student warm-started from every teacher
    leaf whose path and shape match (the shared heads); the student
    inherits the teacher's occupancy grid and does not refresh it unless
    `update_stu_extra`; each epoch draws fresh random poses
    (`data/poses.get_rand_poses`); stages 1 -> 2 -> 3 switch at
    `stage1_iters` / `stage2_iters` (stage 1 skipped when either side is a
    plenoxel field, which has no feature to distill); cosine learning-rate
    schedules.  An MLP field trains at 0.1 x lr (trainer.py:88).

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

Options of both modes (trainer.py:104-117, 498-566, 592-616, 667-684):
  * `upsample_model_steps`: after each listed step a VM field shrinks to
    the occupied box of the finest occupancy cascade (which moves the
    state's `aabb_train`) and then, when `upsample_resolutions` (the CLIs
    set it from `cli.common.upsample_schedule`) has an entry for that
    step, resizes to that many equal-volume voxels per axis over the
    shrunk box; a plenoxel field only resizes, to that resolution per
    axis.  The optimizer state starts afresh.  The resize is left out of
    the step clock.
  * `error_map`: pixels are drawn by importance from a 128 x 128 error
    map per training image (teacher: on the device when preloaded, on the
    host with the host batcher, which applies each step's update one step
    late) or per pose slot of the epoch (distill: updated at stage 3
    under the L2 loss, reset when the epoch's pose count changes).
  * `ema_decay` > 0: an EMA copy of the trained field (`state.ema`),
    updated after every step; `evaluate` renders it, the best checkpoint
    holds it as its params, and every checkpoint holds it as
    `ema_params`.

  * `scan_steps` = K > 1 (trainer.py:316-396, 748-925): K steps run in
    one call of the step's K-step flavor wherever no host work falls
    inside them (`_scan_chunk_len`: the same stage throughout, no
    occupancy or autotune tick and no resize inside, within the epoch
    and the run, starting at a multiple of K); elsewhere single steps.
    A chunk draws what K single steps draw, in the same order, so it
    trains as they would, but on the host batcher with the error map:
    there all K draws come from the map as it stood at the chunk's
    start, and the K steps' updates land when the next chunk or step
    starts (a lag of up to K steps instead of 1).  No CUDA graph yet.
  * `n_devices` > 1, or 0 for the world size: data parallel over the ray
    axis (trainer.py:119-140, `parallel/`), one process per device as
    `torchrun` starts them; `n_devices` must equal the world size.
    `num_rays` rounds up to a multiple of it and `preload` is forced on
    (the host batcher is one stream); each rank draws its rays from its
    own generator (`cfg.seed + 1` folded with the rank) and the
    occupancy updates' draws from the shared one, so the replicas stay
    equal; only rank 0 logs and writes checkpoints, results and
    metrics.

EMA together with resizing raises NotImplementedError: the JAX package's
resize leaves the EMA weights at the old shapes, and its next EMA update
fails (ROADMAP C10).  Real LPIPS needs pretrained weights that neither
machine has; like the JAX package without them, `evaluate` reports the
proxy.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from pvd_tpu_torch.config import PVDConfig
from pvd_tpu_torch.data.png import write_png
from pvd_tpu_torch.data.poses import get_rand_poses, rand_orbit_poses
from pvd_tpu_torch.data.raybatch import RayBatcher
from pvd_tpu_torch.device import resolve_device
from pvd_tpu_torch.engine import checkpoint as ckpt
from pvd_tpu_torch.engine.autotune import retune
from pvd_tpu_torch.engine.optim import (build_optimizer, cosine_schedule,
                                        exp_decay_schedule)
from pvd_tpu_torch.engine.train_steps import (TrainState, make_distill_step,
                                              make_eval_renderer,
                                              make_occ_update,
                                              make_teacher_step,
                                              make_teacher_step_host)
from pvd_tpu_torch.models import tensors_field, vm_field
from pvd_tpu_torch.models.api import param_group_label, trainable_label
from pvd_tpu_torch.ops.rays import ERROR_MAP_CELLS, draw_error_map_inds_np
from pvd_tpu_torch.parallel.dp import (make_dp_eval_renderer,
                                       make_dp_occ_update)
from pvd_tpu_torch.parallel.mesh import rank_device, rank_seed, ray_group_for
from pvd_tpu_torch.params import (field_from_tree, new_field, spec_from_tree,
                                  tree_from_field)
from pvd_tpu_torch.render.occupancy import (draw_occ_inputs,
                                            init_occupancy_state,
                                            mark_untrained_grid)
from pvd_tpu_torch.utils.metrics import (PSNRMeter, compute_ssim,
                                         lpips_available, lpips_proxy,
                                         rgb_lpips)

MODES = ("teacher", "distill")


def _check_cfg(cfg: PVDConfig):
    if (cfg.ema_decay > 0 and cfg.upsample_model_steps
            and cfg.model_type in ("vm", "tensors")):
        raise NotImplementedError(
            "Trainer: EMA (ema_decay > 0) together with resizing "
            "(upsample_model_steps) of a VM or plenoxel field: the JAX "
            "package resizes the field but not its EMA weights, and its "
            "next EMA update fails on the shapes (ROADMAP C10)")


def _frozen_copy(field):
    """A copy of `field` that takes no gradient: the EMA's shadow weights
    (trainer.py:104-106)."""
    ema = copy.deepcopy(field).requires_grad_(False)
    for p in ema.parameters():
        p.grad = None
    return ema


class _HostRow:
    """The per-ray losses of host-batcher steps with the error map ([N]
    or [K, N]), on their way to the host (trainer.py:812-816): on the GPU
    a copy into pinned memory, queued behind the steps, that `numpy()`
    waits for."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.t.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.t = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.t.numpy()


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
    """Trains a teacher (mode "teacher") or distills a frozen teacher into
    a student (mode "distill"), each of any of the four fields.

    `device` defaults to CUDA and raises without a GPU unless "cpu" is
    passed.  The trained field's initial weights come from `cfg.seed`; the
    steps' and occupancy updates' draws from a `torch.Generator` seeded
    with `cfg.seed + 1`; the image order and the distillation poses from
    `np.random.default_rng(cfg.seed)` (the JAX Trainer's host draws); the
    host batcher's from its own producer seeded with `cfg.seed`.
    """

    def __init__(self, cfg: PVDConfig, mode: str = "teacher",
                 name: Optional[str] = None, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        _check_cfg(cfg)
        if mode == "distill" and cfg.stage1_iters and "tensors" in (
                cfg.model_type, cfg.teacher_type):
            # a plenoxel side has no fea_sc: stage 1 has nothing to distill
            # (main_distill_mutual.py:243-246)
            cfg = dataclasses.replace(cfg, stage1_iters=0)
        # data parallel over the ray axis (trainer.py:119-140): params and
        # occupancy replicate, each rank takes a share of every batch
        self.group = ray_group_for(cfg.n_devices, device)
        self.rank = 0 if self.group is None else self.group.rank
        self.device = resolve_device(device if self.group is None
                                     else rank_device(device))
        self.mode = mode
        if self.group is not None:
            cfg = self._dp_config(cfg)
        self.cfg = cfg
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
            field = new_field(self.spec_stu, self.device, gen)
            # distill: a random teacher until load_teacher, as in the JAX
            # package
            self.teacher = (new_field(self.spec_tea, self.device, gen)
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
            occ=init_occupancy_state(self.rspec, self.device),
            ema=_frozen_copy(field) if cfg.ema_decay > 0 else None)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        # the steps' draws: with data parallelism a stream of the rank's
        # own; the shared `generator` keeps the occupancy updates' draws
        # equal on every rank
        self.ray_generator = self.generator if self.group is None else \
            torch.Generator(device=self.device).manual_seed(
                rank_seed(cfg.seed + 1, self.rank))
        # the resize schedule: the steps, and the resolution of each (the
        # CLIs set it from cli.common.upsample_schedule)
        self.upsample_steps = list(cfg.upsample_model_steps)
        self.upsample_resolutions: list = []
        # [B, 128 * 128] when cfg.error_map: a tensor on the device, or a
        # numpy array on the host for the host batcher
        self.error_map = None
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
        if self.rank == 0:
            print(msg, flush=True)

    def _dp_config(self, cfg: PVDConfig) -> PVDConfig:
        """The config of a data-parallel run (trainer.py:129-140):
        num_rays a multiple of the world size, preload on."""
        world = self.group.world
        if cfg.num_rays % world:
            new_rays = -(-cfg.num_rays // world) * world
            self.log(f"[mesh] num_rays {cfg.num_rays} -> {new_rays} "
                     f"(rounded up to n_devices={world})")
            cfg = dataclasses.replace(cfg, num_rays=new_rays)
        if not cfg.preload:
            self.log("[mesh] preload forced on: the host batcher is "
                     "single-stream; DP samples pixels in-shard")
            cfg = dataclasses.replace(cfg, preload=True)
        self.log(f"[mesh] data-parallel over {world} devices "
                 f"({cfg.num_rays // world} rays/device)")
        return cfg

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
        # a resized teacher's shapes come from its leaves
        spec = spec_from_tree(payload["params"], self.spec_tea)
        if spec != self.spec_tea:
            self.spec_tea = spec
            self._steps.clear()
            self._rebuild_renderers()
        self.teacher = field_from_tree(payload["params"], self.spec_tea,
                                       self.device).requires_grad_(False)
        if self.spec_tea.model_type == "hash":
            # frozen: bake the dense levels once (attach_packed)
            self.teacher.bake()
        self.occ_tea = payload["occ"]
        tree = ckpt.warm_start_student(tree_from_field(self.state.field),
                                       payload["params"])
        field = field_from_tree(tree, self.spec_stu, self.device)
        # the EMA starts again from the warm-started weights
        # (trainer.py:214-220)
        self.state = TrainState(
            field=field, opt_state=self.opt.init(dict(
                field.named_parameters())),
            occ=payload["occ"], step=self.state.step,
            ema=None if self.state.ema is None else _frozen_copy(field))
        self.log(f"[load_teacher] {path} (step {payload['step']})")

    def load_student(self, path: str):
        """Resume the trained field, its grid and its step from a
        checkpoint; the optimizer starts afresh (trainer.py:224-246).
        With EMA on, the checkpoint's EMA weights, or a copy of its params
        where it has none."""
        payload = ckpt.load_checkpoint(path, self.device)
        params = payload["params"]
        # the live shapes from the loaded leaves (trainer.py:240-245)
        spec = spec_from_tree(params, self.spec_stu)
        if spec != self.spec_stu:
            self.spec_stu = spec
            self._steps.clear()
            self._rebuild_renderers()
        field = field_from_tree(params, self.spec_stu, self.device)
        ema = None
        if self.state.ema is not None:
            saved = payload["ema_params"]
            ema = (_frozen_copy(field) if saved is None else field_from_tree(
                saved, self.spec_stu, self.device).requires_grad_(False))
        self.state = TrainState(
            field=field, opt_state=self.opt.init(dict(
                field.named_parameters())),
            occ=payload["occ"], step=payload["step"], ema=ema)
        self.log(f"[load_student] {path} (step {payload['step']})")

    def _ckpt_dir(self) -> str:
        return os.path.join(self.workspace, "checkpoints")

    def save(self, stats: Optional[dict] = None,
             filename: Optional[str] = None, field=None) -> Optional[str]:
        """A checkpoint of the trained field, or of `field` as its params
        (trainer.py:248-258), with the EMA weights when EMA is on.  Only
        rank 0 writes (it returns None elsewhere)."""
        if self.rank != 0:
            return None
        ema = self.state.ema
        return ckpt.save_checkpoint(
            self._ckpt_dir(), self.name, self.state.step,
            tree_from_field(self.state.field if field is None else field),
            self.state.occ,
            ema_params=None if ema is None else tree_from_field(ema),
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
        chunk, dev = self.cfg.max_ray_batch, self.device
        if self.group is None:
            self._occ_update = make_occ_update(self.spec_stu, self.rspec,
                                               device=dev)

            def render(spec):
                return make_eval_renderer(spec, self.rspec, chunk=chunk,
                                          device=dev)
        else:
            self._occ_update = make_dp_occ_update(
                self.spec_stu, self.rspec, self.group, device=dev)

            def render(spec):
                return make_dp_eval_renderer(spec, self.rspec, self.group,
                                             chunk=chunk, device=dev)
        self.eval_render = render(self.spec_stu)
        self.eval_render_tea = (render(self.spec_tea)
                                if self.mode == "distill" else None)

    def _get_step_fn(self, stage: int, H: int, W: int, C: int, intr,
                     host: bool = False, scan_steps: int = 0):
        """The step of (stage, shape, host batcher), or its K-step flavor
        for scan_steps = K (trainer.py:279-314, 351-395); data parallel
        over the run's group when it has one."""
        key = (stage, H, W, C, host, scan_steps)
        if key not in self._steps:
            kw = dict(device=self.device, use_error_map=self.cfg.error_map,
                      scan_steps=scan_steps)
            args = (self.rspec, self.opt, self.cfg)
            if self.mode == "teacher" and host:
                self._steps[key] = make_teacher_step_host(
                    self.spec_stu, *args, intr, H, W, image_channels=C,
                    **kw)
            elif self.mode == "teacher":
                self._steps[key] = make_teacher_step(
                    self.spec_stu, *args, intr, H, W, image_channels=C,
                    group=self.group, **kw)
            else:
                self._steps[key] = make_distill_step(
                    self.spec_stu, self.spec_tea, *args, intr, H, W, stage,
                    group=self.group, **kw)
        return self._steps[key]

    def _scan_chunk_len(self, step: int, stage: int, total: int,
                        left_in_epoch: int) -> int:
        """Length of the K-step chunk starting at `step`, or 1
        (trainer.py:316-349): K = scan_steps only where no host work falls
        inside the chunk: one stage throughout, no occupancy or autotune
        tick (multiples of update_extra_interval) strictly inside, no
        scheduled resize after any of its steps, inside both the epoch and
        the run, and starting at a multiple of K."""
        K = self.cfg.scan_steps
        if K <= 1:
            return 1
        if step % K != 0 or left_in_epoch < K or step + K > total:
            return 1
        if self._stage_of(step + K - 1) != stage:
            return 1
        iv = self.cfg.update_extra_interval
        if ((step // iv) + 1) * iv < step + K:
            return 1
        if any(step < s <= step + K for s in self.upsample_steps):
            return 1
        return K

    def _log_scan_chunk(self, logs_k: dict, step: int, K: int, total: int,
                        stage: int, t_start: float):
        """The per-100-step log line of each logging step inside a chunk,
        from its stacked [K] logs (trainer.py:397-415)."""
        rows = [j for j in range(K) if (step + j) % 100 == 0]
        if not rows:
            return
        host = {k: v.cpu().numpy() for k, v in logs_k.items()}
        for j in rows:
            msg = " ".join(f"{k}={float(v[j]):.4f}"
                           for k, v in sorted(host.items()))
            self.log(f"[{self.name}] step {step + j}/{total} stage{stage} "
                     f"{msg} ({time.perf_counter() - t_start:.1f}s)")

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

    def _resize_due(self, step: int) -> bool:
        return (self.spec_stu.model_type in ("vm", "tensors")
                and step in self.upsample_steps)

    def _maybe_vm_resize(self, step: int):
        """The scheduled resize after `step` steps (trainer.py:498-566): a
        VM field shrinks to the box of the finest cascade's cells whose
        density exceeds min(density_thresh, mean density), which becomes
        the state's new `aabb_train` (a new tensor: the distill teacher's
        grid, which the student's state shares until then, keeps its own),
        then upsamples to equal-volume voxels at the step's scheduled
        resolution; a plenoxel field only upsamples.  The optimizer state
        starts afresh."""
        if not self._resize_due(step):
            return
        i = self.upsample_steps.index(step)
        target = (self.upsample_resolutions[i]
                  if i < len(self.upsample_resolutions) else None)
        field = self.state.field
        if self.spec_stu.model_type == "tensors":
            if target is None:
                return
            tensors_field.upsample_params(field, (target,) * 3)
            self.log(f"[plenoxel upsample] res -> {(target,) * 3}")
        else:
            occ = self.state.occ
            H, bound = self.rspec.grid_size, self.rspec.bound
            half = bound / H
            grid = occ.density_grid[-1].cpu().numpy()
            thresh = min(self.cfg.density_thresh, float(occ.mean_density))
            idx = np.argwhere(grid > thresh)
            if len(idx) > 0:
                pos = (2.0 * idx / (H - 1) - 1.0) * (bound - half)
                new_aabb = np.concatenate([pos.min(0) - half,
                                           pos.max(0) + half])
                vm_field.shrink_params(field, occ.aabb_train.cpu().numpy(),
                                       new_aabb, field.spec.vm_resolution)
                self.state.occ = occ.replace(aabb_train=torch.as_tensor(
                    new_aabb, dtype=torch.float32, device=self.device))
                self.log(f"[vm shrink] aabb -> {new_aabb.tolist()} res -> "
                         f"{field.spec.vm_resolution}")
            if target is not None:
                # equal-volume voxels at the scheduled count inside the
                # (shrunk) aabb (trainer.py:551-562)
                cur = self.state.occ.aabb_train.cpu().numpy()
                size = cur[3:] - cur[:3]
                vox = float(np.cbrt(np.prod(size) / float(target) ** 3))
                reso = tuple(int(v) for v in (size / vox).astype(np.int64))
                vm_field.upsample_params(field, reso)
                self.log(f"[vm upsample] res -> {reso}")
        self.spec_stu = field.spec
        self.state.opt_state = self.opt.init(dict(field.named_parameters()))
        self._steps.clear()
        self._rebuild_renderers()

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
            # the EMA weights, when EMA is on, are the best checkpoint's
            # params (trainer.py:600-603)
            path = self.save(stats=stats, filename=f"{self.name}_best.ckpt",
                             field=self.state.ema)
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
        full and partial occupancy update, and how many steps ran inside
        K-step calls (`chunk_steps`)."""
        # the host batcher's threads stop when training ends, or raises
        with contextlib.ExitStack() as stack:
            return self._train(stack, train_ds, valid_ds, max_steps)

    def _train(self, stack, train_ds, valid_ds, max_steps):
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

        def ones_map(n):
            return torch.ones(n, ERROR_MAP_CELLS, device=self.device)

        batcher = None
        if teacher_mode:
            self.state.occ = mark_untrained_grid(
                self.state.occ, train_ds.poses, intr, self.rspec)
            poses = as_dev(train_ds.poses)
            C = int(train_ds.images.shape[-1])
            if cfg.preload:
                images = as_dev(train_ds.images_flat())
            else:
                # host-side batch assembly (trainer.py:656-668)
                batcher = stack.enter_context(contextlib.closing(
                    RayBatcher(train_ds.images, cfg.num_rays,
                               seed=cfg.seed)))
                self.log("[data] host batching (native)")
            if cfg.error_map:
                # with the host batcher the map lives on the host, where
                # the pixels are drawn (trainer.py:667-677)
                self.error_map = (ones_map(len(poses)) if batcher is None
                                  else np.ones((len(poses), ERROR_MAP_CELLS),
                                               np.float32))
            phases = ("padded", "compacted")
        else:
            poses = as_dev(self._distill_epoch_poses(rng_np, train_ds))
            C = 4
            phases = ("stage1", "stage2", "stage3")
            if cfg.error_map:
                # a row per pose slot of the epoch (trainer.py:681-684)
                self.error_map = ones_map(len(poses))
        refresh_occ = teacher_mode or cfg.update_stu_extra
        # the host map's lagged updates: ([(view, cells)], per-ray losses)
        pending = None
        gen = self.ray_generator

        occ_s = {"full": [0, 0.0], "partial": [0, 0.0]}
        side_s = {"eval": 0.0, "ckpt": 0.0, "resize": 0.0}
        chunk_steps = 0  # steps run inside K-step calls
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
                if self.error_map is not None and len(poses) != epoch_len:
                    self.error_map = ones_map(len(poses))
                epoch_len = len(poses)
            steps_this_epoch = min(epoch_len, total - step)
            done = 0
            while done < steps_this_epoch:
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
                emap = self.error_map
                host = batcher is not None
                if host and emap is not None and pending is not None:
                    # apply the previous call's per-ray losses to the host
                    # map in step order before drawing (trainer.py:736-747)
                    draws, losses = pending
                    vals = losses.numpy().reshape(len(draws), -1)
                    for (p_idx, p_cells), v in zip(draws, vals):
                        row = emap[p_idx]
                        row[p_cells] = 0.1 * row[p_cells] + 0.9 * v
                    pending = None
                K = self._scan_chunk_len(step, stage, total,
                                         steps_this_epoch - done)
                if K > 1:
                    # K steps in one call (trainer.py:748-925)
                    step_fn = self._get_step_fn(stage, H, W, C, intr,
                                                host=host, scan_steps=K)
                    if host:
                        logs, pending = self._host_chunk(
                            step_fn, K, batcher, poses, emap, rng_np, H, W,
                            gen)
                    else:
                        idx_k = rng_np.integers(0, len(poses), size=K)
                        pk = poses[torch.as_tensor(idx_k)]
                        if teacher_mode and emap is not None:
                            self.state, self.error_map, logs = step_fn(
                                self.state, images, idx_k, pk, emap, gen)
                        elif teacher_mode:
                            self.state, logs = step_fn(self.state, images,
                                                       idx_k, pk, gen)
                        elif emap is not None:
                            self.state, self.error_map, logs = step_fn(
                                self.state, self.teacher, self.occ_tea, pk,
                                idx_k, emap, gen)
                        else:
                            self.state, logs = step_fn(
                                self.state, self.teacher, self.occ_tea, pk,
                                gen)
                    rows = [{k: v[j] for k, v in logs.items()}
                            for j in range(K)]
                    self.history.extend(rows)
                    self._last_metrics = rows[-1]
                    self._log_scan_chunk(logs, step, K, total, stage,
                                         t_start)
                    step += K
                    done += K
                    chunk_steps += K
                    continue
                step_fn = self._get_step_fn(stage, H, W, C, intr, host=host)
                if host and emap is not None:
                    # draw this step's pixels from the host map
                    # (trainer.py:804-816)
                    inds, cells = draw_error_map_inds_np(
                        rng_np, emap[idx], H, W, cfg.num_rays)
                    pix = batcher.gather(idx, inds)
                    self.state, per_ray, metrics = step_fn(
                        self.state, poses[idx], inds, pix, gen)
                    pending = [(idx, cells)], _HostRow(per_ray)
                elif host:
                    # the batch's image replaces the host draw above, as in
                    # the JAX package
                    idx, inds, pix = batcher.next()
                    self.state, metrics = step_fn(self.state, poses[idx],
                                                  inds, pix, gen)
                elif teacher_mode and emap is not None:
                    self.state, emap[idx], metrics = step_fn(
                        self.state, poses[idx], images[idx], emap[idx], gen)
                elif teacher_mode:
                    self.state, metrics = step_fn(self.state, poses[idx],
                                                  images[idx], gen)
                elif emap is not None:
                    self.state, emap[idx], metrics = step_fn(
                        self.state, self.teacher, self.occ_tea, poses[idx],
                        emap[idx], gen)
                else:
                    self.state, metrics = step_fn(self.state, self.teacher,
                                                  self.occ_tea, poses[idx],
                                                  gen)
                if self._resize_due(step + 1):
                    clock.mark(step + 1)
                    t0 = time.perf_counter()
                    self._maybe_vm_resize(step + 1)
                    self._sync()
                    side_s["resize"] += time.perf_counter() - t0
                    clock.restart()
                self._last_metrics = metrics
                self.history.append(metrics)
                if step % 100 == 0:
                    msg = " ".join(f"{k}={float(v):.4f}"
                                   for k, v in sorted(metrics.items()))
                    self.log(f"[{self.name}] step {step}/{total} stage{stage}"
                             f" {msg} ({time.perf_counter() - t_start:.1f}s)")
                step += 1
                done += 1

            # a spent wall budget makes this epoch boundary the end of
            # training, with the final checkpoint and eval (trainer.py:
            # 962-973)
            spent = (cfg.wall_budget > 0 and step < total
                     and time.perf_counter() - t_start >= cfg.wall_budget)
            if self.group is not None and cfg.wall_budget > 0 \
                    and step < total:
                # the ranks end together: rank clocks differ
                spent = self.group.agree(spent, self.device)
            if spent:
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
            steady = max(wall - t_occ - sum(side_s.values()), 1e-9)
            self.train_stats = {
                "train_steps": steps_done,
                "train_wall_s": wall,
                "train_occ_s": t_occ,
                "train_eval_s": side_s["eval"],
                "train_ckpt_s": side_s["ckpt"],
                "train_resize_s": side_s["resize"],
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
            self.train_stats["chunk_steps"] = chunk_steps
            if teacher_mode:
                self.train_stats["host_batcher"] = batcher is not None
            self.log(f"[{self.name}] e2e throughput: {self.train_stats}")
        self.save()
        return self.state

    def _host_chunk(self, step_fn, K: int, batcher, poses, emap, rng_np,
                    H: int, W: int, gen):
        """One K-step chunk on the host batcher (trainer.py:748-795): K
        batches drawn up front, with the error map each from the host map
        as it stands at the chunk's start.  Returns (stacked logs, the
        pending map update or None)."""
        idxs, inds_l, pix_l, draws = [], [], [], []
        for _ in range(K):
            if emap is not None:
                idx_j = int(rng_np.integers(0, len(poses)))
                inds_j, cells_j = draw_error_map_inds_np(
                    rng_np, emap[idx_j], H, W, self.cfg.num_rays)
                pix_j = batcher.gather(idx_j, inds_j)
                draws.append((idx_j, cells_j))
            else:
                idx_j, inds_j, pix_j = batcher.next()
            idxs.append(idx_j)
            inds_l.append(inds_j)
            pix_l.append(pix_j)
        out = step_fn(self.state, poses[torch.as_tensor(idxs)],
                      np.stack(inds_l), np.stack(pix_l), gen)
        if emap is None:
            self.state, logs = out
            return logs, None
        self.state, per_rays, logs = out
        return logs, (draws, _HostRow(per_rays))

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
        seeded 0, as the JAX package draws it from PRNGKey(0)).  With data
        parallelism every rank renders its share and scores the whole
        image; only rank 0 writes files."""
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
            # the EMA weights when EMA is on (trainer.py:1054-1058)
            field = (self.state.field if self.state.ema is None
                     else self.state.ema)
            occ, render = self.state.occ, self.eval_render
        save_dir = save_dir or os.path.join(self.workspace, "results")
        writes = self.rank == 0
        if writes:
            os.makedirs(save_dir, exist_ok=True)
        meter, ssims, lp, times = PSNRMeter(), [], [], []
        lp_a, lp_v = [], []
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
                if lpips_available():
                    lp_a.append(rgb_lpips(img, gt, "alex"))
                    lp_v.append(rgb_lpips(img, gt, "vgg"))
                else:
                    lp.append(lpips_proxy(img, gt))
            u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            d8 = (np.clip(dep, 0, 1) * 255).astype(np.uint8)
            if writes:
                write_png(os.path.join(save_dir, f"{self.name}_{i:04d}.png"),
                          u8)
                write_png(os.path.join(save_dir,
                                       f"{self.name}_{i:04d}_depth.png"), d8)
            frames.append(u8)
            depth_frames.append(d8)
        if write_video and frames and writes:
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
        if lp_a:
            stats["lpips_alex"] = float(np.mean(lp_a))
            stats["lpips_vgg"] = float(np.mean(lp_v))
        elif lp:
            # random-feature proxy, comparable only with itself
            stats["lpips_proxy"] = float(np.mean(lp))
        self.stats = stats
        self.log(f"[evaluate:{self.name}] {stats}")
        return stats
