"""Plain field, march, composite and occupancy arithmetic of the INGP and
TensoRF-VM fields (a frozen copy of the plain versions in
`pvd_tpu_torch/ops/{fma,hashgrid,vm_sample,sh,composite,aabb,rays}.py`,
`render/{renderer,occupancy}.py` and `models/{heads,vm_field}.py` as of
the benchmark's definition, cut to the settings the cells use: one
cascade, the plain lattice, no cell levels, no background model).

Weights are dicts of tensors named as the program's parameters
(`encoder`, `sigma_net.0.weight`, `planes.0`, `basis_mat`, ...).
`Precision.low` is the benchmark's control: the tables, the encodings and
the composite's inputs rounded to bfloat16, the step below the float32
that the configurations state for them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861)
T_EPS = 1e-4
FLT_MAX = float(np.float32(3.402823466e38))
MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class Precision:
    """low: round tables, encodings and composite inputs to bfloat16."""

    low: bool = False

    def r(self, t):
        return t.to(torch.bfloat16).float() if self.low else t


FULL = Precision()


def fma32(a, b, c):
    """float32 round(a * b + c), the product exact in float64."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).double()
               for x in (a, b, c))
    return (a * b + c).float()


# ---- hash grid (INGP, align_corners False) --------------------------------

@dataclasses.dataclass(frozen=True)
class Grid:
    num_levels: int = 14
    level_dim: int = 2
    base_resolution: int = 16
    log2_size: int = 19
    desired_resolution: int = 2048

    @property
    def per_level_scale(self) -> float:
        return float(np.exp2(np.log2(self.desired_resolution
                                     / self.base_resolution)
                             / (self.num_levels - 1)))

    def scale(self, lv: int) -> float:
        return float(np.exp2(lv * float(np.log2(self.per_level_scale)))
                     * self.base_resolution - 1.0)

    def side(self, lv: int) -> int:
        return int(np.ceil(self.scale(lv))) + 1 + 1

    def hashed(self, lv: int) -> bool:
        return self.side(lv) ** 3 > 2 ** self.log2_size

    def offsets(self) -> list:
        out, off = [0], 0
        for lv in range(self.num_levels):
            res = int(np.ceil(self.base_resolution
                              * self.per_level_scale ** lv))
            n = min(2 ** self.log2_size, (res + 1) ** 3)
            off += int(np.ceil(n / 8) * 8)
            out.append(off)
        return out

    @property
    def table_rows(self) -> int:
        return self.offsets()[-1]


def grid_of(model: dict) -> Grid:
    return Grid(model["hash_num_levels"], model["hash_level_dim"],
                model["hash_base_res"], model["hash_log2_size"],
                int(model["hash_desired_res"] * model["bound"]))


def hash_corners(x01, g: Grid, lv: int):
    """Weights [8, N] and table rows [8, N] of level lv."""
    offs = g.offsets()
    off, size, side = offs[lv], offs[lv + 1] - offs[lv], g.side(lv)
    okf = 1.0 - ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1).float()
    pos = fma32(x01, np.float32(g.scale(lv)), 0.5)
    base = torch.floor(pos)
    frac, bi = pos - base, base.long()
    ws, rows = [], []
    for k in range(8):
        bit = [(k >> d) & 1 for d in range(3)]
        w = frac[:, 0] if bit[0] else 1.0 - frac[:, 0]
        for d in (1, 2):
            w = w * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
        ws.append(w * okf)
        c = [bi[:, d] + bit[d] for d in range(3)]
        if g.hashed(lv):
            row = (c[0] * PRIMES[0]) ^ (c[1] * PRIMES[1]) ^ (c[2] * PRIMES[2])
            row = row & (2 ** g.log2_size - 1)
        else:
            row = (c[0] + c[1] * side + c[2] * side * side).clamp(0, size - 1)
        rows.append(off + row)
    return torch.stack(ws), torch.stack(rows)


def hash_encode(table, x01, g: Grid, prec: Precision = FULL):
    """[N, 3] in [0, 1] -> [N, L * C]; differentiable in the table."""
    table = prec.r(table)
    N, C = x01.shape[0], g.level_dim
    outs = []
    for lv in range(g.num_levels):
        w, rows = hash_corners(x01, g, lv)
        vals = table.index_select(0, rows.reshape(-1)).reshape(8, N, C)
        acc = torch.zeros(N, C, device=x01.device)
        for k in range(8):
            acc = acc + w[k, :, None] * vals[k]
        outs.append(acc)
    return prec.r(torch.cat(outs, dim=-1))


# ---- TensoRF-VM plane x line sample ---------------------------------------

def vm_sample(planes, lines, xn, prec: Precision = FULL):
    """planes 3 x [H, W, R], lines 3 x [L, R], xn [M, 3] -> [3, M, R]."""
    out = []
    for i in range(3):
        m0, m1 = MAT_IDS[i]
        plane, line = prec.r(planes[i]), prec.r(lines[i])
        H, W, R = plane.shape

        def pos(x, size):
            return (x + 1.0) * 0.5 * (size - 1)

        def base(p, size):
            return torch.floor(p).long().clamp(0, max(size - 2, 0))

        def tent(p, b):
            c0 = b.to(p.dtype)
            return (torch.clamp_min(1.0 - (p - c0).abs(), 0.0),
                    torch.clamp_min(1.0 - (p - (c0 + 1.0)).abs(), 0.0))

        px, py = pos(xn[:, m0], W), pos(xn[:, m1], H)
        bx, by = base(px, W), base(py, H)
        wx0, wx1 = tent(px, bx)
        wy0, wy1 = tent(py, by)
        flat = plane.reshape(H * W, R)
        row = by * W + bx
        mf = (wy0 * wx0)[:, None] * flat[row]
        mf = mf + (wy0 * wx1)[:, None] * flat[row + 1]
        mf = mf + (wy1 * wx0)[:, None] * flat[row + W]
        mf = mf + (wy1 * wx1)[:, None] * flat[row + W + 1]
        L = line.shape[0]
        pz = pos(xn[:, VEC_IDS[i]], L)
        b = base(pz, L)
        f = (pz - b.to(pz.dtype))[:, None]
        vf = (1.0 - f) * line[b] + f * line[b + 1]
        out.append(prec.r(mf * vf))
    return torch.stack(out)


# ---- heads, SH, activations ------------------------------------------------

class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-12.0, 12.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def clip(x, lo: float, hi: float):
    """jnp.clip with its gradient (half to an input on a bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def sh4(d):
    """Real SH of degree 4 (16 components, instant-ngp order)."""
    x, y, z = d[..., 0].float(), d[..., 1].float(), d[..., 2].float()
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    c1, c20 = 0.48860251190291992, 1.0925484305920792
    comps = [0.28209479177387814 * torch.ones_like(x),
             -c1 * y, c1 * z, -c1 * x,
             c20 * xy, -c20 * yz,
             0.94617469575755997 * z2 - 0.31539156525251999,
             -c20 * xz, 0.54627421529603959 * (x2 - y2),
             0.59004358992664352 * y * (-3.0 * x2 + y2),
             2.8906114426405538 * xy * z,
             0.45704579946446572 * y * (1.0 - 5.0 * z2),
             0.3731763325901154 * z * (5.0 * z2 - 3.0),
             0.45704579946446572 * x * (1.0 - 5.0 * z2),
             1.4453057213202769 * z * (x2 - y2),
             0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(comps, dim=-1)


def mlp(ws, x, sigmoid: bool = False):
    """Bias-free layers [out, in], ReLU between, in x's dtype."""
    for i, w in enumerate(ws):
        x = F.linear(x, w.to(x.dtype))
        if i != len(ws) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if sigmoid else x


def layers(w: dict, name: str) -> list:
    n = sum(1 for k in w if k.startswith(name + "."))
    return [w[f"{name}.{i}.weight"] for i in range(n)]


HEAD_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def hash_field(w: dict, model: dict, x, d, want_color=True,
               prec: Precision = FULL):
    """INGP field at x [N, 3] in [-bound, bound]: (sigma, rgb, sigma_logit,
    fea_sc [N, 16])."""
    b = model["bound"]
    enc = hash_encode(w["encoder"], (x + b) / (2.0 * b), grid_of(model),
                      prec)
    cdt = HEAD_DTYPES[model["precision"]]
    h = mlp(layers(w, "sigma_net"), enc.to(cdt)).float()
    s = clip(h[..., 0], model["sigma_clip_min"], model["sigma_clip_max"])
    h = torch.cat([s[..., None], h[..., 1:]], dim=-1)
    if not want_color:
        return trunc_exp(s), None, s, h
    rgb = mlp(layers(w, "color_net"),
              torch.cat([sh4(d), h[..., 1:]], dim=-1).to(cdt),
              sigmoid=True).float()
    return trunc_exp(s), rgb, s, h


def vm_projection(basis, Rs: int, Rc: int):
    geo = basis.shape[1]
    top = torch.cat([basis.new_ones(Rs, 1), basis.new_zeros(Rs, geo)], 1)
    return torch.stack([
        torch.cat([top, torch.cat([basis.new_zeros(Rc, 1),
                                   basis[i * Rc:(i + 1) * Rc]], 1)], 0)
        for i in range(3)])


def vm_field(w: dict, model: dict, x, d, aabb, want_color=True,
             prec: Precision = FULL):
    """TensoRF-VM field: (sigma, rgb, sigma_logit, fea_sc [N, 16])."""
    xn = 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0
    prod = vm_sample([w[f"planes.{i}"] for i in range(3)],
                     [w[f"lines.{i}"] for i in range(3)], xn.detach(), prec)
    sc = torch.bmm(prod, vm_projection(w["basis_mat"], model["vm_sigma_rank"],
                                       model["vm_color_rank"]))
    sc = sc[0] + sc[1] + sc[2]
    lo, hi = model["sigma_clip_min"], model["sigma_clip_max"]
    s, c = clip(sc[:, 0], lo, hi), clip(sc[:, 1:], lo, hi)
    fea = torch.cat([s[:, None], c], dim=-1)
    if not want_color:
        return trunc_exp(s), None, s, fea
    cdt = HEAD_DTYPES[model["precision"]]
    rgb = mlp(layers(w, "color_net"), torch.cat([sh4(d), c], dim=-1).to(cdt),
              sigmoid=True).float()
    return trunc_exp(s), rgb, s, fea


def vm_density_l1(w: dict, Rs: int):
    loss = 0.0
    for i in range(3):
        loss = loss + w[f"planes.{i}"][..., :Rs].abs().mean() \
            + w[f"lines.{i}"][..., :Rs].abs().mean()
    return loss


def field(w: dict, model: dict, x, d, aabb, want_color=True,
          prec: Precision = FULL):
    if model["model_type"] == "vm":
        return vm_field(w, model, x, d, aabb, want_color, prec)
    return hash_field(w, model, x, d, want_color, prec)


# ---- rays, march, compaction, composite ------------------------------------

def pixel_dirs(intr, inds, H: int, W: int):
    fx, fy, cx, cy = (float(v) for v in intr)
    px = torch.div(inds, W, rounding_mode="floor")
    py = inds % W
    xs = (py.float() + 0.5 - cx) / fx
    ys = (px.float() + 0.5 - cy) / fy
    zs = torch.ones_like(xs)
    norm = torch.sqrt(fma32(zs, zs, fma32(ys, ys, xs * xs)))
    return torch.stack([xs, ys, zs], dim=-1) / norm[..., None]


def rays(pose, intr, inds, H: int, W: int):
    """(o, d) [N, 3] of flat pixel ids under c2w pose [4, 4]."""
    dirs = pixel_dirs(intr, inds, H, W)
    rot = pose[:3, :3]
    d = fma32(dirs[..., 2:3], rot[:, 2],
              fma32(dirs[..., 1:2], rot[:, 1], dirs[..., 0:1] * rot[:, 0]))
    return pose[:3, 3].expand_as(d).contiguous(), d.contiguous()


def near_far(o, d, aabb, min_near: float):
    inv = 1.0 / d
    lo, hi = (aabb[:3] - o) * inv, (aabb[3:] - o) * inv
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = torch.where(miss, FLT_MAX, near.clamp_min(min_near))
    far = torch.where(miss, FLT_MAX, far)
    return near, far


def dt_min(render: dict) -> float:
    return float(np.float32(2.0 * math.sqrt(3.0) / render["max_steps"]))


def march(bitfield, o, d, nears, fars, render: dict, S: int, u=None):
    """Plain-lattice march of one cascade: (t, dt, mask, t0), [N, S]."""
    N, L, H = o.shape[0], render["max_steps"], render["grid_size"]
    b = render["bound"]
    dtm = dt_min(render)
    t0 = nears if u is None else fma32(dtm, u, nears)
    k = torch.arange(L, dtype=torch.float32, device=o.device)
    ts = fma32(k[None, :], dtm, t0[:, None])
    pos = fma32(ts[..., None], d[:, None, :], o[:, None, :]).clamp(-b, b)
    n = (0.5 * (pos / min(1.0, b) + 1.0) * H).int().clamp(0, H - 1).long()
    occ = bitfield[(n[..., 0] * H + n[..., 1]) * H + n[..., 2]] \
        & (ts < fars[:, None])
    if S >= L:
        mask = torch.zeros(N, S, dtype=torch.bool, device=o.device)
        mask[:, :L] = occ
        t_lat = torch.zeros(N, S, device=o.device)
        t_lat[:, :L] = ts
    else:
        rank = torch.cumsum(occ.long(), dim=1) - 1
        keep = occ & (rank < S)
        slot = torch.where(keep, rank, S)
        t_lat = torch.zeros(N, S + 1, device=o.device)
        t_lat.scatter_(1, slot, ts)
        t_lat = t_lat[:, :S]
        mask = torch.arange(S, device=o.device)[None, :] \
            < keep.sum(dim=1, keepdim=True)
    t = torch.where(mask, t_lat, 0.0)
    return t, torch.where(mask, dtm, 0.0), mask, t0


def compact(mask, budget: int, prefix: bool):
    """(idx, valid, ray_id, total): the first `budget` valid slots of
    mask [N, S] in row-major order."""
    N, S = mask.shape
    slot = torch.arange(budget, device=mask.device)
    if prefix:
        cnt = mask.sum(dim=1)
        total = cnt.sum()
        start = torch.cumsum(cnt, 0) - cnt
        ray = torch.searchsorted(start, slot, right=True) - 1
        valid = slot < torch.clamp(total, max=budget)
        ray = torch.where(valid, ray, 0)
        idx = torch.where(valid, ray * S + (slot - start[ray]), 0)
        return idx, valid, ray, total
    cum = torch.cumsum(mask.reshape(-1).long(), 0)
    total = cum[-1]
    idx = torch.searchsorted(cum, slot + 1)
    valid = slot < torch.clamp(total, max=budget)
    idx = torch.where(valid, idx, 0)
    return idx, valid, idx // S, total


def composite(sigmas, rgbs, dt, t_cum, ray_id, valid, n_rays: int,
              early_stop: bool = False):
    """Front-to-back compositing of a compacted stream: (weights_sum,
    depth, image, weights); autograd differentiates it."""
    M = sigmas.shape[0]
    m = valid.to(sigmas.dtype)
    alphas = (1.0 - torch.exp(-sigmas * dt)) * m
    counts = torch.zeros(n_rays, dtype=torch.long, device=sigmas.device)
    counts.index_add_(0, ray_id, valid.long())
    rstart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(M, device=sigmas.device) - rstart[ray_id]
    maxlen = int(counts.max()) if n_rays else 0
    block = torch.ones(n_rays, maxlen + 1, device=sigmas.device)
    col = torch.where(valid, rank, torch.full_like(rank, maxlen))
    block[ray_id, col] = torch.where(valid, 1.0 - alphas, 1.0)
    excl = torch.cat([torch.ones_like(block[:, :1]),
                      torch.cumprod(block, dim=1)[:, :-1]], dim=1)
    trans = torch.where(valid, excl[ray_id, col], 1.0)
    if early_stop:
        alphas = torch.where(trans < T_EPS, 0.0, alphas)
    weights = alphas * trans
    payload = torch.cat([weights[:, None] * rgbs, weights[:, None],
                         (weights * t_cum * m)[:, None]], dim=-1)
    acc = torch.zeros(n_rays, 5, device=sigmas.device)
    acc.index_add_(0, ray_id, payload)
    return acc[:, 3], acc[:, 4], acc[:, :3], weights


def sample_budget(n_rays: int, spr: float, S: int) -> int:
    m = int(round(n_rays * spr))
    m = max(128, (m + 127) // 128 * 128)
    return min(m, n_rays * S)


def render_train(w, model, render, bitfield, aabb, o, d, bg, u,
                 samples=None, prec: Precision = FULL):
    """The training render of rays [N, 3] on the compacted stream: the
    perturbed march (or `samples` = another model's (t, mask, t0, compact,
    t_c) to replay), the field, the composite over bg [N, 3].  Returns
    (image, point outputs (sigma_logit, fea_sc, rgb), valid, samples)."""
    N = o.shape[0]
    S = render["max_samples"]
    if samples is None:
        nears, fars = near_far(o, d, aabb, render["min_near"])
        t, _, mask, t0 = march(bitfield, o, d, nears, fars, render, S, u)
        budget = sample_budget(N, render["samples_per_ray"], S)
        idx, valid, rid, total = compact(mask, budget, prefix=S <
                                         render["max_steps"])
        t_c = t.reshape(-1)[idx]
        samples = (t0, idx, valid, rid, total, t_c)
    t0, idx, valid, rid, total, t_c = samples
    o_c, d_c = o[rid], d[rid]
    b = render["bound"]
    xyz = fma32(t_c[:, None], d_c, o_c).clamp(-b, b)
    sigma, rgb, s, fea = field(w, model, xyz, d_c, aabb, True, prec)
    dtm = dt_min(render)
    dt_c = torch.where(valid, dtm, 0.0)
    t_cum = torch.where(valid, t_c + dt_c - t0[rid], 0.0)
    ws, _, image, _ = composite(prec.r(sigma), prec.r(rgb), dt_c, t_cum,
                                rid, valid, N)
    image = image + (1.0 - ws)[:, None] * bg
    return image, (s, fea, rgb), valid, samples
