// K4 / K5: the VM field's plane x line sample, forward and backward.
//
// Replaces pvd_tpu/models/vm_field.py:160 _plane_sample4 (fwd, reached via
// _plane_packed_mxu :130 and _line_mxu :112 in _joint_feats :208) and its
// backward _plane_sample4_bwd :173 plus the autodiff of _line_mxu and of
// mf * vf.  For each sample n and branch i (plane axes MAT_IDS[i], line
// axis VEC_IDS[i]) and channel c of the sigma|color concatenated tables:
//
//   px = (xn[m0] + 1) * 0.5 * (W - 1),  py likewise with m1 and H
//   bx = clip(floor px, 0, W - 2), by likewise
//   tent weights wx_k = max(0, 1 - |px - (bx + k)|), wy_k likewise
//   mf = sum_k w_k * plane[row_k, c], rows i, i+1, i+W, i+W+1 (i = by*W+bx)
//   pz = (xn[v] + 1) * 0.5 * (L - 1), b = clip(floor pz, 0, L - 2),
//   f = pz - b (no clamp: the line extrapolates outside [0, L-1])
//   vf = (1 - f) * line[b, c] + f * line[b + 1, c]
//   prod[i, n, c] = mf * vf
//
// The TPU version gathers the four corner rows with shifted index streams
// and turns the line sample into a one-hot [N, L] matmul for its matrix
// unit; here one thread computes one (branch, sample, channel): the
// channels of a sample sit in consecutive lanes, so each corner row is one
// coalesced 256-B read at R = 64, and the line is a two-row interpolation.
// One launch per branch (a template on the branch), so every table and
// axis index is known at compile time.
//
// Backward (K5): with g = dL/dprod, the plane rows receive w_k * vf * g and
// the line rows (1 - f) * mf * g and f * mf * g, by fp32 atomicAdd into
// zeroed dense gradients (the sum order varies from run to run).  The
// plane and line samples are recomputed rather than saved (2 x 100 MB at
// 131,072 samples).  Positions get no gradient: the JAX package
// stop-gradients them (vm_field.py:194-202).
//
// Bound on the H100: memory.  K4 writes 3 * M * R * 4 B (100 MB at
// M = 131,072, R = 64) and reads the touched plane rows once; K5 reads g
// (100 MB) and writes the dense plane gradients (69 MB at 300^3).  The
// arithmetic is ~12 flops per output.  K5's atomics contend on the lines
// (300 rows per branch, hit by every sample); a per-block pre-sum is the
// next step if the profile shows it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// mirrors pvd_tpu_torch/kernels.py VMTables
struct VMTables {
  float* plane[3];  // [H_i * W_i, R], x fastest
  float* line[3];   // [L_i, R]
  int H[3];
  int W[3];
  int L[3];
};

// branch i samples plane axes (M0[i], M1[i]) and line axis V[i]
template <int BR> struct Axes;
template <> struct Axes<0> { static constexpr int m0 = 0, m1 = 1, v = 2; };
template <> struct Axes<1> { static constexpr int m0 = 0, m1 = 2, v = 1; };
template <> struct Axes<2> { static constexpr int m0 = 1, m1 = 2, v = 0; };

struct Corners {
  int row0;  // by * W + bx
  int W;
  float w[4];  // (dx, dy) bits: (0,0), (1,0), (0,1), (1,1)
  int lb;      // line base row
  float lf;    // line fraction (unclamped)
};

__device__ __forceinline__ float grid_pos(float x, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(x, 1.f), 0.5f), (float)(size - 1));
}

__device__ __forceinline__ int clamped_base(float p, int size) {
  return (int)fminf(fmaxf(floorf(p), 0.f), (float)(size - 2));
}

__device__ __forceinline__ void tent(float p, int base, float* w) {
  const float c0 = (float)base;
  w[0] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, c0))));
  w[1] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, __fadd_rn(c0, 1.f)))));
}

// branch sizes are kernel arguments, so no by-value struct is indexed at
// run time (which would copy it to local memory)
template <int BR>
__device__ __forceinline__ Corners corners(const float* __restrict__ xn,
                                           int s, int H, int W, int L) {
  Corners c;
  const float px = grid_pos(xn[3 * s + Axes<BR>::m0], W);
  const float py = grid_pos(xn[3 * s + Axes<BR>::m1], H);
  const float pz = grid_pos(xn[3 * s + Axes<BR>::v], L);
  const int bx = clamped_base(px, W), by = clamped_base(py, H);
  float wx[2], wy[2];
  tent(px, bx, wx);
  tent(py, by, wy);
  c.w[0] = __fmul_rn(wy[0], wx[0]);
  c.w[1] = __fmul_rn(wy[0], wx[1]);
  c.w[2] = __fmul_rn(wy[1], wx[0]);
  c.w[3] = __fmul_rn(wy[1], wx[1]);
  c.row0 = by * W + bx;
  c.W = W;
  c.lb = clamped_base(pz, L);
  c.lf = __fsub_rn(pz, (float)c.lb);
  return c;
}

__device__ __forceinline__ float plane_sample(const float* __restrict__ p,
                                              const Corners& c, int R,
                                              int ch) {
  const int r = c.row0;
  float acc = __fmul_rn(c.w[0], p[r * R + ch]);
  acc = __fadd_rn(acc, __fmul_rn(c.w[1], p[(r + 1) * R + ch]));
  acc = __fadd_rn(acc, __fmul_rn(c.w[2], p[(r + c.W) * R + ch]));
  acc = __fadd_rn(acc, __fmul_rn(c.w[3], p[(r + c.W + 1) * R + ch]));
  return acc;
}

__device__ __forceinline__ float line_sample(const float* __restrict__ l,
                                             const Corners& c, int R,
                                             int ch) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, c.lf), l[c.lb * R + ch]),
                   __fmul_rn(c.lf, l[(c.lb + 1) * R + ch]));
}

// the wrapper keeps n * R and H * W * R below 2^31, so indices are 32-bit
template <int BR>
__global__ void vm_sample_fwd_kernel(const float* __restrict__ plane,
                                     const float* __restrict__ line, int H,
                                     int W, int L,
                                     const float* __restrict__ xn,
                                     float* __restrict__ out, int n, int R) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * R) return;
  const int s = idx / R;
  const int ch = idx - s * R;
  const Corners c = corners<BR>(xn, s, H, W, L);
  out[idx] = __fmul_rn(plane_sample(plane, c, R, ch),
                       line_sample(line, c, R, ch));
}

template <int BR>
__global__ void vm_sample_bwd_kernel(const float* __restrict__ plane,
                                     const float* __restrict__ line, int H,
                                     int W, int L, float* __restrict__ gpl,
                                     float* __restrict__ gli,
                                     const float* __restrict__ xn,
                                     const float* __restrict__ g, int n,
                                     int R) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * R) return;
  const float gv = g[idx];
  if (gv == 0.f) return;  // masked-out slots: nothing to add
  const int s = idx / R;
  const int ch = idx - s * R;
  const Corners c = corners<BR>(xn, s, H, W, L);
  const float gp = __fmul_rn(gv, line_sample(line, c, R, ch));
  const int r = c.row0;
  if (c.w[0] != 0.f) atomicAdd(&gpl[r * R + ch], __fmul_rn(c.w[0], gp));
  if (c.w[1] != 0.f) atomicAdd(&gpl[(r + 1) * R + ch], __fmul_rn(c.w[1], gp));
  if (c.w[2] != 0.f)
    atomicAdd(&gpl[(r + c.W) * R + ch], __fmul_rn(c.w[2], gp));
  if (c.w[3] != 0.f)
    atomicAdd(&gpl[(r + c.W + 1) * R + ch], __fmul_rn(c.w[3], gp));
  const float gl = __fmul_rn(gv, plane_sample(plane, c, R, ch));
  const float w0 = __fsub_rn(1.f, c.lf);
  if (w0 != 0.f) atomicAdd(&gli[c.lb * R + ch], __fmul_rn(w0, gl));
  if (c.lf != 0.f) atomicAdd(&gli[(c.lb + 1) * R + ch], __fmul_rn(c.lf, gl));
}

static unsigned blocks_of(long long n, int R, int threads) {
  return (unsigned)((n * R + threads - 1) / threads);
}

extern "C" int pvd_vm_sample_fwd(VMTables t, const float* xn, float* out,
                                 long long n, int R, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256, m = (int)n;
  const unsigned b = blocks_of(n, R, threads);
  cudaStream_t st = (cudaStream_t)stream;
  vm_sample_fwd_kernel<0><<<b, threads, 0, st>>>(
      t.plane[0], t.line[0], t.H[0], t.W[0], t.L[0], xn, out, m, R);
  vm_sample_fwd_kernel<1><<<b, threads, 0, st>>>(
      t.plane[1], t.line[1], t.H[1], t.W[1], t.L[1], xn, out + n * R, m, R);
  vm_sample_fwd_kernel<2><<<b, threads, 0, st>>>(
      t.plane[2], t.line[2], t.H[2], t.W[2], t.L[2], xn, out + 2 * n * R, m,
      R);
  return (int)cudaGetLastError();
}

extern "C" int pvd_vm_sample_bwd(VMTables t, VMTables grad, const float* xn,
                                 const float* g, long long n, int R,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256, m = (int)n;
  const unsigned b = blocks_of(n, R, threads);
  cudaStream_t st = (cudaStream_t)stream;
  vm_sample_bwd_kernel<0><<<b, threads, 0, st>>>(
      t.plane[0], t.line[0], t.H[0], t.W[0], t.L[0], grad.plane[0],
      grad.line[0], xn, g, m, R);
  vm_sample_bwd_kernel<1><<<b, threads, 0, st>>>(
      t.plane[1], t.line[1], t.H[1], t.W[1], t.L[1], grad.plane[1],
      grad.line[1], xn, g + n * R, m, R);
  vm_sample_bwd_kernel<2><<<b, threads, 0, st>>>(
      t.plane[2], t.line[2], t.H[2], t.W[2], t.L[2], grad.plane[2],
      grad.line[2], xn, g + 2 * n * R, m, R);
  return (int)cudaGetLastError();
}
