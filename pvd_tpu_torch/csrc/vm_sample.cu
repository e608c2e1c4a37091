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
// unit; here the line is a two-row interpolation of the same rows.
//
// Forward (K4).  Bound on the H100: memory.  It writes 3 * M * R * 4 B
// (100 MB at M = 131,072, R = 64) and reads the touched plane and line rows
// once (the 3 x 23 MB plane tables at 300^3 fit the 50 MB L2 only in part);
// the arithmetic is ~14 flops per output.  The first design ran one thread
// per (branch, sample, channel), one launch per branch: each thread redid
// the whole corner setup (3 positions, floors, clamps, tent weights) and a
// run-time idx / R division for its one channel, then issued six 4-byte
// loads and one 4-byte store, ~25 M threads of ~80 instructions, so it was
// bound by issue, not by memory (4.3x its byte bound, and slower than three
// F.grid_sample calls that do only the plane half); its 100 MB output went
// through the L2 with the default policy, evicting the plane rows the next
// samples read.  The design now: one launch for the three branches
// (blockIdx.y, uniform per block, dispatched to the Axes<BR> instantiations
// with every table and size at a compile-time index), and a group of G
// lanes per (sample, branch), G a template constant (a power of two, R/8
// rounded up: 8 at R = 64), so no division is left.  Each lane does the
// corner setup once and covers two quads of 4 consecutive channels (q and
// q + G): per quad it reads the 4 plane corner rows and the 2 line rows as
// float4 through the read-only path and writes one float4 with a streaming
// store (st.global.cs, evict-first), so the output streams past the L2 and
// the table rows stay resident.  Groups of R/4 lanes, one quad a lane,
// timed slower on the H100 (the corner setup twice as often, half the
// loads in flight per lane), and so did R/16 lanes (PERF.md §6).  The
// wrapper takes that instantiation when R % 4 == 0 and every table is
// 16-byte aligned; otherwise the scalar instantiation of the same kernel,
// one channel per lane.  The per-channel arithmetic is grid_pos,
// clamped_base, tent and the __fmul_rn / __fadd_rn order of plane_sample and
// line_sample, so both give the first design's bits.
//
// Backward (K5), replacing vm_field.py:173 _plane_sample4_bwd and the
// autodiff of _line_mxu and of mf * vf: with g = dL/dprod, the plane rows
// receive w_k * vf * g and the line rows (1 - f) * mf * g and f * mf * g,
// by fp32 atomics into zeroed dense gradients (the sum order varies from
// run to run).  The plane and line samples are recomputed rather than
// saved (2 x 100 MB at 131,072 samples).  Positions get no gradient: the
// JAX package stop-gradients them (vm_field.py:194-202).  Bound on the
// H100: memory; it reads g (100 MB at 131,072 samples, R = 64) and writes
// the dense gradients (69 MB at 300^3, zeroed by one fill of one buffer
// that the six gradients are views of), but what it pays for beyond that
// is atomics.  The first design had K4's first shape: a thread per
// (branch, sample, channel), one launch per branch, the corner setup and a
// run-time idx / R division in every thread, scalar loads, and up to six
// scalar atomicAdds a thread, ~76 M at 131,072 samples, every valid
// sample's two line rows landing on one 300 x 64 table per branch; 3.9x
// its bound.  The design now: one launch for the three branches
// (blockIdx.y into the Axes<BR> instantiations, as K4) and a group of G
// lanes per sample, one channel quad a lane (G = R/4 rounded up to a power
// of two: 16 at R = 64), g read as float4 with a streaming load one sample
// ahead, a sample whose quad of g is zero skipped (the compacted stream's
// invalid tail is all zero).  Each group walks a run of K5_RUN consecutive
// samples: along a ray they share plane cells and line rows, so each lane
// sums the run's contributions at the current cell's corner vertices in
// registers, and a vertex's sum is added only when the run leaves it
// (move_run: moving one cell over keeps the two shared vertices), with one
// float4 atomicAdd (sm_90's vector atomics, one REDG) per vertex row.  The
// lanes of one warp hold other samples, so a cross-lane pre-sum (K7's
// peer_sum) would find few peers.  Without float4 lanes (R % 4 != 0 or an
// unaligned pointer) the scalar instantiation runs one channel a lane
// (ops/vm_sample.py k5_variant).  Each contribution is the first design's
// __fmul_rn product of the same operands; only the order of the sums
// differs.  Measured and dropped (PERF.md §6): a copy of each
// branch's line table in shared memory (76.8 KB at L = 300, R = 64, two
// blocks an SM), flushed once per block with float4 atomics, was slower
// than the direct float4 atomics at both timed shapes (its shared-memory
// adds are compare-and-swap loops and every block flushes the whole
// table); runs of 32 samples in blocks that stride over the stream, and
// runs of 4 or 16, timed slower than runs of 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K5_THREADS 256
#define K5_RUN 8  // consecutive samples one K5 lane group walks

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 2))
#define PVD_VECTOR_ATOMICS 1
#else
#define PVD_VECTOR_ATOMICS 0
#endif

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

// K4, one channel: the plane and line samples' product
__device__ __forceinline__ float vm_prod(const float* __restrict__ p,
                                         const float* __restrict__ l,
                                         const Corners& c, int R, int ch) {
  return __fmul_rn(plane_sample(p, c, R, ch), line_sample(l, c, R, ch));
}

// K4, four channels ch..ch+3 (ch % 4 == 0, R % 4 == 0, 16-byte aligned
// tables): per channel the ops of plane_sample and line_sample, in order
__device__ __forceinline__ float4 vm_prod4(const float* __restrict__ p,
                                           const float* __restrict__ l,
                                           const Corners& c, int R, int ch) {
  const int r = c.row0;
  const float4 a = __ldg(reinterpret_cast<const float4*>(p + r * R + ch));
  const float4 b =
      __ldg(reinterpret_cast<const float4*>(p + (r + 1) * R + ch));
  const float4 d =
      __ldg(reinterpret_cast<const float4*>(p + (r + c.W) * R + ch));
  const float4 e =
      __ldg(reinterpret_cast<const float4*>(p + (r + c.W + 1) * R + ch));
  const float4 u = __ldg(reinterpret_cast<const float4*>(l + c.lb * R + ch));
  const float4 v =
      __ldg(reinterpret_cast<const float4*>(l + (c.lb + 1) * R + ch));
  const float g = __fsub_rn(1.f, c.lf);
  const float pa[4] = {a.x, a.y, a.z, a.w}, pb[4] = {b.x, b.y, b.z, b.w},
              pd[4] = {d.x, d.y, d.z, d.w}, pe[4] = {e.x, e.y, e.z, e.w},
              lu[4] = {u.x, u.y, u.z, u.w}, lv[4] = {v.x, v.y, v.z, v.w};
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc = __fmul_rn(c.w[0], pa[j]);
    acc = __fadd_rn(acc, __fmul_rn(c.w[1], pb[j]));
    acc = __fadd_rn(acc, __fmul_rn(c.w[2], pd[j]));
    acc = __fadd_rn(acc, __fmul_rn(c.w[3], pe[j]));
    o[j] = __fmul_rn(acc, __fadd_rn(__fmul_rn(g, lu[j]),
                                    __fmul_rn(c.lf, lv[j])));
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// K4, branch BR: lane `lane` of sample s's group of G lanes covers the
// channel quads (V4) or the channels lane, lane + G, ...; out is the
// branch's [n, R]
template <int BR, int G, bool V4>
__device__ __forceinline__ void vm_fwd_branch(
    const float* __restrict__ plane, const float* __restrict__ line, int H,
    int W, int L, const float* __restrict__ xn, float* __restrict__ out,
    int n, int R) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(gid / G), lane = (int)(gid % G);
  if (s >= n) return;
  const Corners c = corners<BR>(xn, s, H, W, L);
  float* o = out + (long long)s * R;
  if constexpr (V4) {
    for (int ch = 4 * lane; ch < R; ch += 4 * G)
      __stcs(reinterpret_cast<float4*>(o + ch),
             vm_prod4(plane, line, c, R, ch));
  } else {
    for (int ch = lane; ch < R; ch += G)
      __stcs(o + ch, vm_prod(plane, line, c, R, ch));
  }
}

// the wrapper keeps n * R and H * W * R below 2^31, so indices within a
// branch are 32-bit; branch i's output starts at out + i * n * R
template <int G, bool V4>
__global__ void __launch_bounds__(256)
    vm_sample_fwd_kernel(VMTables t, const float* __restrict__ xn,
                         float* __restrict__ out, int n, int R) {
  const long long span = (long long)n * R;
  switch (blockIdx.y) {
    case 0:
      vm_fwd_branch<0, G, V4>(t.plane[0], t.line[0], t.H[0], t.W[0], t.L[0],
                              xn, out, n, R);
      break;
    case 1:
      vm_fwd_branch<1, G, V4>(t.plane[1], t.line[1], t.H[1], t.W[1], t.L[1],
                              xn, out + span, n, R);
      break;
    default:
      vm_fwd_branch<2, G, V4>(t.plane[2], t.line[2], t.H[2], t.W[2], t.L[2],
                              xn, out + 2 * span, n, R);
  }
}

// K5: add V floats (a float4 or one float) to a global gradient row; the
// result is unused, so a float4 add is one fire-and-forget REDG on sm_90
template <bool V4>
__device__ __forceinline__ void add_global(float* dst, const float* v) {
  if constexpr (V4) {
#if PVD_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
#else
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, v[j]);
#endif
  } else {
    atomicAdd(dst, v[0]);
  }
}

template <int V>
__device__ __forceinline__ bool any_nonzero(const float (&v)[V]) {
  bool nz = false;
#pragma unroll
  for (int j = 0; j < V; ++j) nz |= v[j] != 0.f;
  return nz;
}

// K5: V consecutive floats of a table row through the read-only path, or
// of g with a streaming load (read once)
template <bool V4>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float* v) {
  if constexpr (V4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(src);
  }
}

template <bool V4>
__device__ __forceinline__ void load_stream(const float* __restrict__ src,
                                            float* v) {
  if constexpr (V4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldcs(src);
  }
}

// K5: a run's sums at the K corner vertices of a cell.  acc[k] belongs to
// vertex row row0 + (k & 1) + (k >> 1) * W (a plane cell's 4 corners; a
// line's rows b, b + 1 with K = 2, W = 1).  Moving to cell nrow, a vertex
// that is also a corner of nrow keeps its sum, in its new slot; the others
// are added to dst and leave.  nrow = -1 adds them all.
template <bool V4, int K, int V>
__device__ __forceinline__ void move_run(float* __restrict__ dst, int row0,
                                         int nrow, int W, int R, int ch,
                                         float (&acc)[K][V]) {
  if (row0 == nrow) return;
  float nacc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) nacc[k][j] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int vr = row0 + (k & 1) + (k >> 1) * W;
    bool kept = false;
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2) {
      if (nrow >= 0 && vr == nrow + (k2 & 1) + (k2 >> 1) * W) {
        kept = true;
#pragma unroll
        for (int j = 0; j < V; ++j) nacc[k2][j] = acc[k][j];
      }
    }
    if (!kept && row0 >= 0 && any_nonzero(acc[k]))
      add_global<V4>(dst + vr * R + ch, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = nacc[k][j];
}

// K5, branch BR: block b's group `grp` of G lanes walks the K5_RUN
// consecutive samples from (b * K5_THREADS / G + grp) * K5_RUN; lane `lane`
// keeps channel unit u = lane, lane + G, ... (a quad with V4, a channel
// without) and sums the run's contributions at the current plane cell's 4
// corners and line rows lb, lb + 1 in registers (move_run).
template <int BR, int G, bool V4>
__device__ __forceinline__ void vm_bwd_branch(
    const float* __restrict__ plane, const float* __restrict__ line, int H,
    int W, int L, float* __restrict__ gpl, float* __restrict__ gli,
    const float* __restrict__ xn, const float* __restrict__ g, int n,
    int R) {
  constexpr int V = V4 ? 4 : 1;
  const int lane = threadIdx.x % G;
  const int units = R / V;
  const int s0 = (blockIdx.x * (K5_THREADS / G) + threadIdx.x / G) * K5_RUN;
  const int s1 = min(s0 + K5_RUN, n);
  for (int u = lane; u < units; u += G) {
    const int ch = u * V;
    float pacc[4][V], lacc[2][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pacc[0][j] = pacc[1][j] = pacc[2][j] = pacc[3][j] = 0.f;
      lacc[0][j] = lacc[1][j] = 0.f;
    }
    int prow = -1, lrow = -1;
    float gnext[V];
    if (s0 < s1) load_stream<V4>(g + (long long)s0 * R + ch, gnext);
    for (int s = s0; s < s1; ++s) {
      float gv[V];
#pragma unroll
      for (int j = 0; j < V; ++j) gv[j] = gnext[j];
      if (s + 1 < s1) load_stream<V4>(g + (long long)(s + 1) * R + ch, gnext);
      if (!any_nonzero(gv)) continue;  // masked-out slots add nothing
      const Corners c = corners<BR>(xn, s, H, W, L);
      move_run<V4>(gpl, prow, c.row0, W, R, ch, pacc);
      move_run<V4>(gli, lrow, c.lb, 1, R, ch, lacc);
      prow = c.row0;
      lrow = c.lb;
      const int r = c.row0;
      float pa[V], pb[V], pd[V], pe[V], lu[V], lv[V];
      load_row<V4>(plane + r * R + ch, pa);
      load_row<V4>(plane + (r + 1) * R + ch, pb);
      load_row<V4>(plane + (r + W) * R + ch, pd);
      load_row<V4>(plane + (r + W + 1) * R + ch, pe);
      load_row<V4>(line + c.lb * R + ch, lu);
      load_row<V4>(line + (c.lb + 1) * R + ch, lv);
      const float w0 = __fsub_rn(1.f, c.lf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // the first design's products (line_sample, plane_sample, then
        // the weights), so each contribution keeps its bits
        const float ls =
            __fadd_rn(__fmul_rn(w0, lu[j]), __fmul_rn(c.lf, lv[j]));
        const float gp = __fmul_rn(gv[j], ls);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c.w[k] != 0.f)
            pacc[k][j] = __fadd_rn(pacc[k][j], __fmul_rn(c.w[k], gp));
        float ps = __fmul_rn(c.w[0], pa[j]);
        ps = __fadd_rn(ps, __fmul_rn(c.w[1], pb[j]));
        ps = __fadd_rn(ps, __fmul_rn(c.w[2], pd[j]));
        ps = __fadd_rn(ps, __fmul_rn(c.w[3], pe[j]));
        const float gl = __fmul_rn(gv[j], ps);
        if (w0 != 0.f) lacc[0][j] = __fadd_rn(lacc[0][j], __fmul_rn(w0, gl));
        if (c.lf != 0.f)
          lacc[1][j] = __fadd_rn(lacc[1][j], __fmul_rn(c.lf, gl));
      }
    }
    move_run<V4>(gpl, prow, -1, W, R, ch, pacc);
    move_run<V4>(gli, lrow, -1, 1, R, ch, lacc);
  }
}

// K5: one launch for the three branches (blockIdx.y), each instantiation at
// compile-time table indices; g's branch i starts at g + i * n * R.  Three
// blocks an SM (at most 85 registers a thread)
template <int G, bool V4>
__global__ void __launch_bounds__(K5_THREADS, 3)
    vm_sample_bwd_kernel(VMTables t, VMTables gr, const float* __restrict__ xn,
                         const float* __restrict__ g, int n, int R) {
  const long long span = (long long)n * R;
  switch (blockIdx.y) {
    case 0:
      vm_bwd_branch<0, G, V4>(t.plane[0], t.line[0], t.H[0], t.W[0], t.L[0],
                              gr.plane[0], gr.line[0], xn, g, n, R);
      break;
    case 1:
      vm_bwd_branch<1, G, V4>(t.plane[1], t.line[1], t.H[1], t.W[1], t.L[1],
                              gr.plane[1], gr.line[1], xn, g + span, n, R);
      break;
    default:
      vm_bwd_branch<2, G, V4>(t.plane[2], t.line[2], t.H[2], t.W[2], t.L[2],
                              gr.plane[2], gr.line[2], xn, g + 2 * span, n,
                              R);
  }
}

template <int G, bool V4>
static int launch_k4(const VMTables& t, const float* xn, float* out, int n,
                     int R, cudaStream_t st) {
  const int threads = 256;
  const dim3 grid((unsigned)(((long long)n * G + threads - 1) / threads), 3);
  vm_sample_fwd_kernel<G, V4><<<grid, threads, 0, st>>>(t, xn, out, n, R);
  return (int)cudaGetLastError();
}

template <bool V4>
static int launch_k4_group(const VMTables& t, const float* xn, float* out,
                           int n, int R, int group, cudaStream_t st) {
  switch (group) {
    case 1: return launch_k4<1, V4>(t, xn, out, n, R, st);
    case 2: return launch_k4<2, V4>(t, xn, out, n, R, st);
    case 4: return launch_k4<4, V4>(t, xn, out, n, R, st);
    case 8: return launch_k4<8, V4>(t, xn, out, n, R, st);
    case 16: return launch_k4<16, V4>(t, xn, out, n, R, st);
    case 32: return launch_k4<32, V4>(t, xn, out, n, R, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4: vec4 = 1 takes the float4 instantiation (the wrapper has checked R % 4
// and the tables' alignment); `lanes` per (sample, branch), a power of two
// up to 32, is the wrapper's pick (ops/vm_sample.py k4_variant)
extern "C" int pvd_vm_sample_fwd(VMTables t, const float* xn, float* out,
                                 long long n, int R, int vec4, int lanes,
                                 void* stream) {
  if (n <= 0) return 0;
  if (vec4 && R % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return vec4 ? launch_k4_group<true>(t, xn, out, (int)n, R, lanes, st)
              : launch_k4_group<false>(t, xn, out, (int)n, R, lanes, st);
}

template <int G, bool V4>
static int launch_k5(const VMTables& t, const VMTables& gr, const float* xn,
                     const float* g, int n, int R, cudaStream_t st) {
  const long long per_block = (long long)(K5_THREADS / G) * K5_RUN;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), 3);
  vm_sample_bwd_kernel<G, V4><<<grid, K5_THREADS, 0, st>>>(t, gr, xn, g, n,
                                                          R);
  return (int)cudaGetLastError();
}

template <bool V4>
static int launch_k5_group(const VMTables& t, const VMTables& gr,
                           const float* xn, const float* g, int n, int R,
                           int group, cudaStream_t st) {
  switch (group) {
    case 1: return launch_k5<1, V4>(t, gr, xn, g, n, R, st);
    case 2: return launch_k5<2, V4>(t, gr, xn, g, n, R, st);
    case 4: return launch_k5<4, V4>(t, gr, xn, g, n, R, st);
    case 8: return launch_k5<8, V4>(t, gr, xn, g, n, R, st);
    case 16: return launch_k5<16, V4>(t, gr, xn, g, n, R, st);
    case 32: return launch_k5<32, V4>(t, gr, xn, g, n, R, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5: grad's tables zeroed; vec4 = 1 takes the float4 instantiation (the
// wrapper has checked R % 4 and every pointer's alignment); `lanes` per
// (sample, branch), a power of two up to 32, is the wrapper's pick
// (ops/vm_sample.py k5_variant)
extern "C" int pvd_vm_sample_bwd(VMTables t, VMTables grad, const float* xn,
                                 const float* g, long long n, int R,
                                 int vec4, int lanes, void* stream) {
  if (n <= 0) return 0;
  if (vec4 && R % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return vec4 ? launch_k5_group<true>(t, grad, xn, g, (int)n, R, lanes, st)
              : launch_k5_group<false>(t, grad, xn, g, (int)n, R, lanes, st);
}
