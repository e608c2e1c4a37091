"""The rendering cell: the window drives the program's
`engine/train_steps.make_eval_renderer` `render_image` over an orbit of
test cameras (the eval march, the 1x / 4x / 16x budget ladder, early
stop), each image copied to the host as the Trainer's eval does.

The field and its occupancy grid are the benchmark's own: hash weights
drawn from the seed (`weights.make`, the traffic's `field.init`, the
density output scaled by `field.density_gain` so that rays through the
grid's solid parts stop early as they do in a trained opaque object) on a
fixed grid of `scene.BITFIELDS`.  Set-up loads them into a field of the
program's, builds its occupancy state from the grid and renders warm-up
images.  The orbit is a fixed set of cameras at one elevation; the seed
sets where it starts.

The reference renders a sample of the window's images, drawn from the
seed, from the same weights and grid.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import flops, scene, weights
from portbench.drivers.train import (check_spec, head_model,
                                     program_config, sync)
from portbench.reference import nerf, render as ref_render
from portbench.trace import span


class RenderCell:
    unit = "image"

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda",
                 workdir: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = workdir

    def setup(self):
        from pvd_tpu_torch.engine.train_steps import make_eval_renderer
        from pvd_tpu_torch.params import new_field
        from pvd_tpu_torch.render.occupancy import init_occupancy_state
        t, c, r = self.traffic, self.config, self.config["render"]
        cfg = program_config(c, dict(t["program"], mode="render"), self.seed,
                             os.path.join(self.workdir or ".", "workspace"))
        self.spec, self.rspec = cfg.model_spec(cfg.model_type), \
            cfg.render_spec()
        check_spec(self.spec, c["model"])
        f = t["field"]
        gen = weights.generator(self.seed, 1, self.device)
        self.w = weights.make(c["model"], f["init"], gen, self.device)
        weights.scale_density(self.w, f["density_gain"])
        self.bitfield = torch.as_tensor(
            scene.BITFIELDS[f["grid"]](r["grid_size"]), device=self.device)
        self.field = new_field(self.spec, self.device)
        weights.load_into(self.field, self.w)
        occ = init_occupancy_state(self.rspec, self.device)
        grid = torch.where(self.bitfield, 2.0 * r["density_thresh"], 0.0)
        grid = grid.reshape(occ.density_grid.shape)
        self.occ = occ.replace(bitfield=self.bitfield.clone(),
                               density_grid=grid, mean_density=grid.mean(),
                               iter_density=16)
        self.render = make_eval_renderer(self.spec, self.rspec,
                                         chunk=t["max_ray_batch"],
                                         device=self.device)
        H, W = t["H"], t["W"]
        self.intr = scene.intrinsics(H, W)
        start = float(np.random.default_rng(self.seed).uniform(0, 360))
        self.poses = [scene.nerf_matrix_to_ngp(p, c["scene"]["scale"])
                      for p in scene.orbit_poses(t["orbit_views"],
                                                 t["orbit_phi"], start)]
        warm = scene.orbit_poses(t["warmup_images"], t["orbit_phi"],
                                 start + 180.0 / t["orbit_views"])
        for p in warm:
            self._image(scene.nerf_matrix_to_ngp(p, c["scene"]["scale"]))
        sync(self.device)

    def _image(self, pose):
        with span("image"):
            out = self.render(self.field, self.occ, pose, self.intr,
                              self.traffic["H"], self.traffic["W"])
            img = out.image.cpu()
        return out, img

    def _run(self, seconds: float, count: int, tracer=None) -> dict:
        images, samples, failed, keep = 0, 0, 0, {}
        if tracer is not None:
            tracer.start()
            tracer.begin()
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            k = images % len(self.poses)
            out, img = self._image(self.poses[k])
            images += 1
            samples += out.samples
            failed += int(not bool(torch.isfinite(img).all()))
            keep.setdefault(k, img)
            t1 = time.perf_counter()
            if (count and images >= count) or (not count
                                                and t1 - t0 >= seconds):
                break
        if tracer is not None:
            tracer.end()
            tracer.stop()
        self.kept = keep
        return {"units": images, "wall_s": t1 - t0, "failed": failed,
                "valid_samples": float(samples), "work": images,
                "flops": samples * flops.sample_flops(self.config["model"],
                                                      False)}

    def window(self, seconds: float) -> dict:
        return self._run(seconds, 0)

    def trace_window(self, tracer=None) -> dict:
        return self._run(0.0, self.traffic["trace_images"], tracer)

    def release(self):
        """Free the program's field, grid and renderer; the benchmark's
        weights and grid stay for the reference."""
        self.field = self.occ = self.render = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """image_mean_gap: the largest mean absolute gap, over a sample of
        the window's images drawn from the seed, between the program's
        image (with `control` the reference's in bfloat16) and the
        reference's, both from the benchmark's weights and grid."""
        rng = np.random.default_rng(self.seed + 1)
        done = sorted(self.kept)
        pick = rng.choice(done, size=min(self.traffic["check_images"],
                                         len(done)), replace=False)
        model = head_model(self.config["model"], self.config["precision"])
        b = model["bound"]
        render = dict(self.config["render"], bound=b,
                      samples_per_ray=self.traffic["program"][
                          "samples_per_ray"])
        aabb = torch.tensor([-b, -b, -b, b, b, b], device=self.device)
        args = (self.w, model, render, self.bitfield, aabb)
        mean = 0.0
        for k in pick:
            pose = torch.as_tensor(self.poses[int(k)], device=self.device)
            view = (pose, self.intr, self.traffic["H"], self.traffic["W"],
                    self.traffic["max_ray_batch"])
            ref, _ = ref_render.render_image(*args, *view)
            if control:
                side, _ = ref_render.render_image(*args, *view,
                                                  nerf.Precision(low=True))
            else:
                side = self.kept[int(k)].to(self.device)
            mean = max(mean, float((side - ref).abs().mean()))
        return {"image_mean_gap": mean}
