"""Plain full-image eval render (a frozen copy of
`pvd_tpu_torch/engine/train_steps.make_eval_renderer` and the eval branch
of `render/renderer.render_rays` as of the benchmark's definition): the
whole 1024-step lattice per ray, the compacted stream at a per-chunk
budget of samples_per_ray x chunk with the 1x / 4x / 16x ladder, early
stop at transmittance 1e-4, white background."""

from __future__ import annotations

import torch

from portbench.reference import nerf


@torch.no_grad()
def render_image(w, model, render, bitfield, aabb, pose, intr, H: int,
                 W: int, chunk: int, prec=nerf.FULL):
    """(image [H, W, 3], depth [H, W]) of the c2w pose [4, 4]."""
    n = H * W
    L = render["max_steps"]
    spr0 = render["samples_per_ray"]
    ladder = [spr0, spr0 * 4.0, spr0 * 16.0]
    imgs, deps = [], []
    for head in range(0, n, chunk):
        inds = torch.clamp(head + torch.arange(chunk, device=pose.device),
                           max=n - 1)
        o, d = nerf.rays(pose, intr, inds, H, W)
        nears, fars = nerf.near_far(o, d, aabb, render["min_near"])
        t, _, mask, t0 = nerf.march(bitfield, o, d, nears, fars, render, L)
        for spr in ladder:
            budget = nerf.sample_budget(chunk, spr, L)
            idx, valid, rid, total = nerf.compact(mask, budget, prefix=False)
            if int(total) <= budget or spr == ladder[-1]:
                break
        t_c = t.reshape(-1)[idx]
        b = render["bound"]
        xyz = nerf.fma32(t_c[:, None], d[rid], o[rid]).clamp(-b, b)
        sigma, rgb, _, _ = nerf.field(w, model, xyz, d[rid], aabb, True, prec)
        dt_c = torch.where(valid, nerf.dt_min(render), 0.0)
        t_cum = torch.where(valid, t_c + dt_c - t0[rid], 0.0)
        ws, depth_raw, image, _ = nerf.composite(
            prec.r(sigma), prec.r(rgb), dt_c, t_cum, rid, valid, chunk,
            early_stop=True)
        image = image + (1.0 - ws)[:, None]
        depth = torch.clamp(depth_raw - nears, min=0.0) / (fars - nears
                                                           + 1e-6)
        rows = min(head + chunk, n) - head
        imgs.append(image[:rows])
        deps.append(depth[:rows])
    return torch.cat(imgs).reshape(H, W, 3), torch.cat(deps).reshape(H, W)
