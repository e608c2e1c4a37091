"""The VM field's plane x line sample (port of pvd_tpu/models/vm_field.py:
`_plane_packed_mxu` :130 -> `_plane_sample4` :160 with its backward :173,
and `_line_mxu` :112).

For branch i (plane axes MAT_IDS[i], line axis VEC_IDS[i]) and normalized
positions xn [M, 3] in [-1, 1]:
  * plane [H, W, R] (rows x-fastest, i = by * W + bx): bilinear sample with
    tent weights max(0, 1 - |p - c|), which vanish outside the grid
    (ops/packing.py:99-115), at base clip(floor p, 0, size - 2);
  * line [L, R]: linear sample at b = clip(floor p, 0, L - 2) with weights
    (1 - f, f), f = p - b unclamped (it extrapolates outside [0, L - 1]);
  * prod[i] = plane sample * line sample, [3, M, R] float32.

`vm_sample` runs kernels K4 (forward) and K5 (backward, `csrc/vm_sample.cu`)
on CUDA tensors through an autograd Function, and `vm_sample_plain` on CPU
tensors, where autograd differentiates the gathers.  Positions carry no
gradient (the JAX package stop-gradients them).  K4 and K5 have a float4
and a scalar instantiation; `k4_variant` and `k5_variant` pick one by the
rank and the pointers' alignment.
"""

from __future__ import annotations

import torch

from pvd_tpu_torch import kernels

MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)


def _grid_pos(x, size: int):
    return (x + 1.0) * 0.5 * (size - 1)


def _base(p, size: int):
    return torch.floor(p).long().clamp(0, max(size - 2, 0))


def _tent(p, base):
    c0 = base.to(p.dtype)
    w0 = torch.clamp_min(1.0 - (p - c0).abs(), 0.0)
    w1 = torch.clamp_min(1.0 - (p - (c0 + 1.0)).abs(), 0.0)
    return w0, w1


def vm_sample_plain(planes, lines, xn):
    """Plain PyTorch version: planes 3 x [H_i, W_i, R], lines 3 x [L_i, R],
    xn [M, 3] -> prod [3, M, R]."""
    xn = xn.detach()
    out = []
    for i in range(3):
        m0, m1 = MAT_IDS[i]
        plane, line = planes[i], lines[i]
        H, W, R = plane.shape
        px, py = _grid_pos(xn[:, m0], W), _grid_pos(xn[:, m1], H)
        bx, by = _base(px, W), _base(py, H)
        wx0, wx1 = _tent(px, bx)
        wy0, wy1 = _tent(py, by)
        flat = plane.reshape(H * W, R)
        row = by * W + bx
        mf = (wy0 * wx0)[:, None] * flat[row]
        mf = mf + (wy0 * wx1)[:, None] * flat[row + 1]
        mf = mf + (wy1 * wx0)[:, None] * flat[row + W]
        mf = mf + (wy1 * wx1)[:, None] * flat[row + W + 1]
        L = line.shape[0]
        pz = _grid_pos(xn[:, VEC_IDS[i]], L)
        b = _base(pz, L)
        f = (pz - b.to(pz.dtype))[:, None]
        vf = (1.0 - f) * line[b] + f * line[b + 1]
        out.append(mf * vf)
    return torch.stack(out)


def vm_sample_bwd_plain(planes, lines, xn, g):
    """Plain backward: autograd of `vm_sample_plain` for the upstream
    gradient g [3, M, R] -> (plane grads, line grads)."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in planes]
        ls = [v.detach().requires_grad_() for v in lines]
        grads = torch.autograd.grad(vm_sample_plain(ps, ls, xn), ps + ls, g)
    return list(grads[:3]), list(grads[3:])


def _check(name: str, planes, lines, xn):
    tensors = {f"plane{i}": p for i, p in enumerate(planes)}
    tensors.update({f"line{i}": v for i, v in enumerate(lines)})
    dev = kernels.check_cuda(name, xn=xn, **tensors)
    R = planes[0].shape[-1]
    for t in list(tensors.values()) + [xn]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: tables and xn must be float32")
    for p, v in zip(planes, lines):
        if p.ndim != 3 or v.ndim != 2 or p.shape[-1] != R or v.shape[-1] != R:
            raise ValueError(f"{name}: planes [H, W, R], lines [L, R], one R")
        if min(p.shape[0], p.shape[1], v.shape[0]) < 2:
            raise ValueError(f"{name}: every axis needs >= 2 grid points")
    if xn.ndim != 2 or xn.shape[1] != 3:
        raise ValueError(f"{name}: xn must be [M, 3], got {tuple(xn.shape)}")
    if max([xn.shape[0] * R] + [p.numel() for p in planes]) >= 2 ** 31:
        raise ValueError(f"{name}: the kernels index with 32-bit ints")
    return dev, R


def _tables(planes, lines) -> kernels.VMTables:
    t = kernels.VMTables()
    for i in range(3):
        t.plane[i] = planes[i].data_ptr()
        t.line[i] = lines[i].data_ptr()
        t.H[i], t.W[i] = planes[i].shape[0], planes[i].shape[1]
        t.L[i] = lines[i].shape[0]
    return t


def _variant(R: int, ptrs, per_lane: int) -> tuple:
    """("float4", lanes) when R % 4 == 0 and every address in `ptrs` is
    16-byte aligned, else ("scalar", lanes); lanes per (sample, branch) is
    R / per_lane channels (float4) or R (scalar), rounded up to a power of
    two, at most 32."""
    vec4 = R % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    per_lane = per_lane if vec4 else 1
    lanes = 1
    while lanes * per_lane < R and lanes < 32:
        lanes *= 2
    return ("float4" if vec4 else "scalar"), lanes


def k4_variant(R: int, ptrs) -> tuple:
    """K4's instantiation for rank R and the tables' addresses `ptrs`:
    float4 lanes cover two channel quads each (R / 8 lanes), scalar lanes
    one channel (`_variant`, csrc/vm_sample.cu)."""
    return _variant(R, ptrs, 8)


def k5_variant(R: int, ptrs) -> tuple:
    """K5's instantiation for rank R and the addresses `ptrs` of every
    table, gradient and g: float4 lanes cover one channel quad each (R / 4
    lanes), scalar lanes one channel (`_variant`, csrc/vm_sample.cu)."""
    return _variant(R, ptrs, 4)


def grad_buffers(planes, lines):
    """Zeroed gradients shaped as planes and lines: views of one buffer,
    one fill for the six, each starting on a 16-byte boundary."""
    tables = (*planes, *lines)
    offsets, total = [], 0
    for t in tables:
        offsets.append(total)
        total += -(-t.numel() // 4) * 4
    buf = torch.zeros(total, dtype=planes[0].dtype, device=planes[0].device)
    views = [buf[o:o + t.numel()].view(t.shape)
             for o, t in zip(offsets, tables)]
    return views[:3], views[3:]


def vm_sample_fwd(planes, lines, xn):
    """prod [3, M, R]: K4 on CUDA tensors (the instantiation `k4_variant`
    picks), the plain version on CPU tensors.  No autograd (see
    `vm_sample`)."""
    if xn.device.type == "cpu":
        with torch.no_grad():
            return vm_sample_plain(planes, lines, xn)
    dev, R = _check("vm_sample_fwd", planes, lines, xn)
    M = xn.shape[0]
    out = torch.empty(3, M, R, device=dev)
    kind, lanes = k4_variant(R, [t.data_ptr() for t in (*planes, *lines)])
    with torch.cuda.device(dev):
        kernels.launch("pvd_vm_sample_fwd", _tables(planes, lines),
                       xn.data_ptr(), out.data_ptr(), M, R,
                       int(kind == "float4"), lanes,
                       kernels.stream_ptr(xn))
    vm_sample_fwd.launches += 1
    return out


vm_sample_fwd.launches = 0


def vm_sample_bwd(planes, lines, xn, g):
    """(plane grads, line grads) for the upstream gradient g [3, M, R]: K5
    on CUDA tensors (fp32 atomics; the instantiation `k5_variant` picks;
    the six gradients are views of one buffer, `grad_buffers`), the plain
    version on CPU tensors."""
    if xn.device.type == "cpu":
        return vm_sample_bwd_plain(planes, lines, xn, g)
    dev, R = _check("vm_sample_bwd", planes, lines, xn)
    M = xn.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (3, M, R):
        raise ValueError(f"vm_sample_bwd: g must be float32 [3, {M}, {R}]")
    g = g.contiguous()
    g_planes, g_lines = grad_buffers(planes, lines)
    kind, lanes = k5_variant(
        R, [t.data_ptr() for t in (*planes, *lines, *g_planes, *g_lines, g)])
    with torch.cuda.device(dev):
        kernels.launch("pvd_vm_sample_bwd", _tables(planes, lines),
                       _tables(g_planes, g_lines), xn.data_ptr(),
                       g.data_ptr(), M, R, int(kind == "float4"), lanes,
                       kernels.stream_ptr(xn))
    vm_sample_bwd.launches += 1
    return g_planes, g_lines


vm_sample_bwd.launches = 0


class _VMSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, p0, p1, p2, l0, l1, l2):
        ctx.save_for_backward(xn, p0, p1, p2, l0, l1, l2)
        return vm_sample_fwd([p0, p1, p2], [l0, l1, l2], xn)

    @staticmethod
    def backward(ctx, g):
        xn, p0, p1, p2, l0, l1, l2 = ctx.saved_tensors
        g_planes, g_lines = vm_sample_bwd([p0, p1, p2], [l0, l1, l2], xn, g)
        return (None, *g_planes, *g_lines)


def vm_sample(planes, lines, xn):
    """Differentiable plane x line sample -> prod [3, M, R] (module
    docstring).  planes 3 x [H_i, W_i, R] and lines 3 x [L_i, R] float32,
    contiguous; xn [M, 3] float32, no gradient."""
    xn = xn.detach()
    if xn.device.type == "cpu":
        return vm_sample_plain(planes, lines, xn)
    return _VMSample.apply(xn.contiguous(), *planes, *lines)
