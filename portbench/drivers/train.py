"""The distillation cell: the window drives the program's
`engine/trainer.Trainer.train` in distill mode (a frozen INGP teacher into
a TensoRF-VM student at stage 3).

Set-up builds one Trainer, loads the benchmark's weights into it, drives
its first `check_steps` steps through `train` (the window's own call and
feed) while recording what the reference needs, runs on to
`setup_steps`, and hands that Trainer to the window.  The window is one
`train` call that runs until `--seconds` have passed and the epoch ends
(the Trainer's `wall_budget`); its clock starts, after a synchronise,
just before that call and stops at the checkpoint `train` writes at its
end, which the benchmark's wrapper of the instance's `save` skips.

After the window the reference follows the first three steps from the
same weights and draws: each step's loss, the first gradient's norm per
leaf (the program's from its AdamW first moment after one step) and the
norm of each leaf's change after the three steps.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import numpy as np
import torch

from portbench import flops, scene, weights
from portbench.reference import nerf, train as ref_train
from portbench.trace import span


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(config: dict, traffic: dict, seed: int, workspace: str):
    """The PVDConfig of the cell (the program's own config class)."""
    from pvd_tpu_torch.config import PVDConfig
    m = config["model"] if "model" in config else config["student"]
    r = config["render"]
    kw = dict(
        workspace=workspace, seed=int(seed), iters=traffic["iters"],
        lr=traffic["lr"], num_rays=traffic["num_rays"],
        max_steps=r["max_steps"], update_extra_interval=traffic.get(
            "update_extra_interval", 16),
        max_ray_batch=traffic.get("max_ray_batch", 4096),
        precision=config["precision"], preload=traffic.get("preload", False),
        bound=m["bound"], scale=config.get("scene", {}).get("scale", 0.8),
        dt_gamma=0.0, min_near=r["min_near"],
        density_thresh=r["density_thresh"], bg_radius=-1.0,
        grid_size=r["grid_size"], max_samples=traffic["max_samples"],
        samples_per_ray=traffic["samples_per_ray"],
        autotune_budget=traffic.get("autotune_budget", False),
        eval_interval=1 << 30, data_type="synthetic",
        sigma_clip_min=m["sigma_clip_min"],
        sigma_clip_max=m["sigma_clip_max"])
    if traffic["mode"] == "distill":
        s, t = config["student"], config["teacher"]
        kw.update(model_type=s["model_type"], teacher_type=t["model_type"],
                  resolution0=s["vm_resolution"][0],
                  resolution1=s["vm_resolution"][0],
                  stage1_iters=traffic["stage1_iters"],
                  stage2_iters=traffic["stage2_iters"],
                  update_stu_extra=traffic["update_stu_extra"],
                  distill_mode=config["distill_mode"],
                  loss_type=config["loss_type"],
                  hash_cell_levels=t["hash_cell_levels"],
                  **{k: config["loss"][k] for k in config["loss"]})
    else:
        kw.update(model_type=m["model_type"],
                  hash_cell_levels=m["hash_cell_levels"])
    return PVDConfig(**kw)


def check_spec(spec, model: dict):
    """The program's field spec holds every width of the config file."""
    for k, v in model.items():
        if hasattr(spec, k):
            got = getattr(spec, k)
            got = list(got) if isinstance(got, tuple) else got
            if got != v:
                raise ValueError(f"the program's {k} is {got}, the "
                                 f"configuration's {v}")


def head_model(model: dict, precision: str) -> dict:
    return dict(model, precision=precision)


class TrainCell:
    """Set-up, window, trace and check of the distillation cell."""

    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda",
                 workdir: str | None = None):
        if traffic["mode"] != "distill":
            raise ValueError(f"TrainCell drives distill mode, not "
                             f"{traffic['mode']!r}")
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.mode = traffic["mode"]
        self.workdir = workdir or tempfile.mkdtemp(prefix="portbench_")
        self.records = []  # the recorded first steps
        self.recording = False
        self.window_end = None  # called at the first save after it starts
        self._wrapped = {}

    # ---- hooks on the program's Trainer instance --------------------------
    def _hook(self, trainer):
        """Wrap the step functions (to record the first steps' draws and
        label their host time) and `save` (to stop the window's clock)."""
        get_step = trainer._get_step_fn
        cell = self

        def wrap(fn):
            def step(*args):
                pre = cell._pre_step(args) if cell.recording else None
                with span("step"):
                    out = fn(*args)
                if pre is not None:
                    cell._post_step(pre, out)
                return out
            return step

        def get_step_fn(*a, **k):
            fn = get_step(*a, **k)  # the Trainer caches its step functions
            if fn not in cell._wrapped:
                cell._wrapped[fn] = wrap(fn)
            return cell._wrapped[fn]

        def save(*a, **k):
            if cell.window_end is not None:
                end, cell.window_end = cell.window_end, None
                end()
            return None

        trainer._get_step_fn = get_step_fn
        trainer.save = save

    def _pre_step(self, args):
        state, _, _, pose, _ = args
        return {"gen": self.trainer.ray_generator.get_state().clone(),
                "step": state.step, "pose": pose.detach().clone()}

    def _post_step(self, rec, out):
        metrics = out[-1]
        rec["loss"] = metrics["loss"].detach().clone()
        if not self.records:
            # AdamW's first moment after one step is (1 - b1) x the gradient
            mu = self.trainer.state.opt_state.mu
            rec["grad_norm"] = {
                n: (m / (1.0 - ref_train.B1)).norm().item()
                for n, m in mu.items()}
        self.records.append(rec)
        if len(self.records) >= self.traffic["check_steps"]:
            self.recording = False

    # ---- set-up -----------------------------------------------------------
    def _dataset(self):
        """Distillation renders from random poses and reads no images: a
        split of the scene's size and intrinsics, without views."""
        c = self.config["scene"]
        return scene.Split(np.zeros((0, 4, 4), np.float32), None,
                           scene.intrinsics(c["H"], c["W"]), c["H"], c["W"])

    def setup(self):
        from pvd_tpu_torch.engine.trainer import Trainer
        cfg = program_config(self.config, self.traffic, self.seed,
                             os.path.join(self.workdir, "workspace"))
        self.cfg = cfg
        self.ds = self._dataset()
        trainer = Trainer(cfg, mode=self.mode, device=self.device)
        self.trainer = trainer
        gen = weights.generator(self.seed, 1, self.device)
        tm, sm = self.config["teacher"], self.config["student"]
        check_spec(trainer.spec_tea, tm)
        check_spec(trainer.spec_stu, sm)
        self.w_teacher = weights.make(tm, self.config["teacher_init"], gen,
                                      self.device)
        w_student = weights.make(sm, "recipe", gen, self.device)
        weights.load_into(trainer.state.field, w_student)
        trainer.load_teacher(self._teacher_checkpoint(trainer))
        # the student warm-starts from the teacher's shared heads
        self.w0 = {n: (self.w_teacher[n] if n in self.w_teacher
                       and self.w_teacher[n].shape == v.shape else v)
                   .clone() for n, v in w_student.items()}
        self._hook(trainer)
        self.recording = True
        trainer.train(self.ds, None, max_steps=self.traffic["check_steps"])
        self.recording = False
        field = dict(trainer.state.field.named_parameters())
        self.change_norm = {n: (p.detach() - self.w0[n]).norm().item()
                            for n, p in field.items()}
        trainer.train(self.ds, None, max_steps=self.traffic["setup_steps"])
        sync(self.device)

    def _teacher_checkpoint(self, trainer) -> str:
        from pvd_tpu_torch.engine.checkpoint import save_checkpoint
        from pvd_tpu_torch.params import new_field, tree_from_field
        from pvd_tpu_torch.render.occupancy import init_occupancy_state
        teacher = new_field(trainer.spec_tea, self.device)
        weights.load_into(teacher, self.w_teacher)
        H = self.config["render"]["grid_size"]
        bits = torch.as_tensor(
            scene.BITFIELDS[self.config["teacher_grid"]](H),
            device=self.device)
        occ = init_occupancy_state(trainer.rspec, self.device)
        grid = torch.where(bits, 2.0 * self.config["render"][
            "density_thresh"], 0.0).reshape(occ.density_grid.shape)
        occ = occ.replace(bitfield=bits, density_grid=grid,
                          mean_density=grid.mean(), iter_density=16)
        self.teacher_bitfield = bits
        path = save_checkpoint(os.path.join(self.workdir, "teacher"),
                               "teacher", 0, tree_from_field(teacher), occ)
        del teacher
        return path

    # ---- the window ------------------------------------------------------
    def _run(self, max_steps: int, wall: float, tracer=None) -> dict:
        tr = self.trainer
        t = {}

        def end():
            sync(self.device)
            t["t1"] = time.perf_counter()
            t["step1"] = tr.state.step
            if tracer is not None:
                tracer.end()

        self.window_end = end
        tr.cfg.wall_budget = wall
        if tracer is not None:
            tracer.start()
            tracer.begin()
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t["step0"] = tr.state.step
        t["hist0"] = len(tr.history)
        t["t0"] = time.perf_counter()
        tr.train(self.ds, None, max_steps=max_steps)
        tr.cfg.wall_budget = 0.0
        if tracer is not None:
            tracer.stop()
        steps = t["step1"] - t["step0"]
        hist = tr.history[t["hist0"]:t["hist0"] + steps]
        return {"units": steps, "wall_s": t["t1"] - t["t0"], "history": hist}

    def window(self, seconds: float) -> dict:
        res = self._run(1 << 40, float(seconds))
        return self._summarise(res)

    def trace_window(self, tracer=None) -> dict:
        res = self._run(self.trainer.state.step + self.traffic["trace_steps"],
                        0.0, tracer)
        return self._summarise(res)

    def _summarise(self, res: dict) -> dict:
        hist = res["history"]
        losses = torch.stack([h["loss"].float() for h in hist]).cpu()
        budget = self.trainer.rspec.sample_budget(self.cfg.num_rays)
        fracs = torch.stack([h["compact_frac"].float() for h in hist]).cpu()
        valid = float((fracs.clamp(max=1.0) * budget).sum())
        res.update(failed=int((~torch.isfinite(losses)).sum()),
                   valid_samples=valid,
                   work=res["units"] * self.cfg.num_rays,
                   flops=self._flops(res["units"], valid))
        return res

    def _flops(self, steps: int, valid: float) -> float:
        return valid * (flops.sample_flops(self.config["student"], True)
                        + flops.sample_flops(self.config["teacher"], False))

    def release(self):
        """Free the program's state before the reference runs."""
        self.trainer = None
        self._wrapped.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check -------------------------------------------------------
    def reference_steps(self, prec=nerf.FULL):
        """The reference's three steps: (losses, first grads' norms,
        changes' norms) per leaf."""
        params = {n: v.clone().requires_grad_() for n, v in self.w0.items()}
        opt = ref_train.AdamW(params, ref_train.schedules(
            params, self.cfg.lr, self.cfg.iters))
        model_s = head_model(self.config["student"], self.config["precision"])
        model_t = head_model(self.config["teacher"], self.config["precision"])
        b = model_s["bound"]
        render = dict(self.config["render"], bound=b,
                      max_samples=self.cfg.max_samples,
                      samples_per_ray=self.cfg.samples_per_ray)
        aabb = torch.tensor([-b, -b, -b, b, b, b], device=self.device)
        H, W = self.ds.H, self.ds.W
        intr = self.ds.intrinsics
        N = self.cfg.num_rays
        losses, grad0 = [], None
        for rec in self.records:
            gen = torch.Generator(device=self.device)
            gen.set_state(rec["gen"])
            inds = torch.randint(0, H * W, (N,), generator=gen,
                                 device=self.device)
            bg = torch.rand(N, 3, generator=gen, device=self.device)
            u = torch.rand(N, generator=gen, device=self.device)
            loss, grads = ref_train.distill_step(
                params, opt, rec["step"], self.w_teacher, model_s, model_t,
                render, self.config["loss"], self.teacher_bitfield, aabb,
                rec["pose"], intr, H, W, inds, bg, u, prec)
            losses.append(float(loss))
            if grad0 is None:
                grad0 = {n: g.norm().item() for n, g in grads.items()}
        change = {n: (p.detach() - self.w0[n]).norm().item()
                  for n, p in params.items()}
        return losses, grad0, change

    def program_readings(self):
        return ([float(r["loss"]) for r in self.records],
                self.records[0]["grad_norm"], self.change_norm)

    def input_gaps(self) -> dict:
        """pose_mismatch: the recorded poses that are not among the
        benchmark's own copy of the Trainer's epoch of random poses (an
        exact check of the input the reference took from the run)."""
        from portbench.reference.poses import distill_epoch_poses
        poses = torch.as_tensor(distill_epoch_poses(self.seed),
                                device=self.device)
        bad = 0
        for rec in self.records:
            d = (poses - rec["pose"]).abs().flatten(1).amax(1)
            bad += int(float(d.min()) != 0.0)
        return {"pose_mismatch": float(bad)}

    def check(self, control: bool = False) -> dict:
        """{number: value}: the program (or with `control` the reference in
        bfloat16) against the reference."""
        ref = self.reference_steps()
        side = self.reference_steps(nerf.Precision(low=True)) if control \
            else self.program_readings()
        out = gaps(side, ref)
        if not control:
            out.update(self.input_gaps())
        return out


def gaps(side, ref) -> dict:
    """loss_gap: the largest relative gap of a step's loss; loss1_gap: the
    first step's, before the two sides' weights differ; grad_gap and
    change_gap: the worst leaf's gap of norms, against the larger of the
    reference leaf's norm and the median leaf's; grad_gap_median and
    change_gap_median: the median over the leaves of the same gaps, which
    one leaf's rounding cannot move.  Leaves whose reference gradient is
    under 1e-3 of the median leaf's are left out of the change."""
    (l_s, g_s, c_s), (l_r, g_r, c_r) = side, ref
    loss = max(abs(a - b) / abs(b) for a, b in zip(l_s, l_r))
    loss1 = abs(l_s[0] - l_r[0]) / abs(l_r[0])
    med_g = statistics.median(g_r.values())
    grad = [abs(g_s[n] - g_r[n]) / max(g_r[n], med_g) for n in g_r]
    moved = [n for n in c_r if g_r[n] >= 1e-3 * med_g]
    med_c = statistics.median(c_r[n] for n in moved)
    change = [abs(c_s[n] - c_r[n]) / max(c_r[n], med_c) for n in moved]
    return {"loss_gap": loss, "loss1_gap": loss1, "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}
