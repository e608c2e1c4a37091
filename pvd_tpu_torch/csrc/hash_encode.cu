// K1: multi-resolution hash-grid encode (INGP), forward, D = 3, C = 2;
// K7: its table gradient;
// K10: the cell-packed levels' encode; K11: the cell table's gradient;
// K12, K13: K1 and K7 on a 2-D grid (the background model's).
//
// K1 replaces pvd_tpu/ops/hashgrid.py:533 hash_encode's corner levels: the
// corner rows of _corner_rows (:193) and the weighted corner sum of
// _corner_gather_sum (:255).  The TPU version fetches dense levels from a
// neighbourhood-packed copy of the table (build_packed_dense, :420); that is
// a gather layout of the same rows, so this kernel reads the table directly.
//
// Per (point, level): pos = x01 * scale + 0.5 (one FMA, as XLA:CPU computes
// it), base = floor(pos), frac = pos - base; the 8 corners c = base + bits
// (bit d of the corner id selects +1 along dim d) have d-linear weights and
// rows  dense:  c0 + c1*side + c2*side^2
//       hashed: (c0*1 ^ c1*2654435761 ^ c2*805459861) mod 2^32, & (2^19-1)
// plus the level's offset.  A coordinate outside [0, 1] zeroes all levels.
// The corner sum accumulates in f32 in corner order, not XLA's order: the
// plain version and the JAX package agree with it to ~1e-7 relative.
//
// A launch covers a list of levels (HashLevels.n_levels entries); entry i
// writes level slot level[i] of a row of out_levels slots, so the corner
// levels (K1) and the cell levels (K10) fill one [N, L * 2] output.
//
// Bound on the H100: memory.  Each (point, level) reads 8 rows of 8 B at
// scattered addresses (32-byte sectors, so ~4x the useful bytes) and writes
// 8 B.  At the full INGP config the whole table is 5.3M rows x 8 B = 42 MB,
// which fits the 50 MB L2, so the scattered reads are mostly L2 hits after
// the first touch.  Design: one thread per (point, level), level fastest,
// so a warp covers ~2 points across all levels: the point's 12 bytes are
// read once per warp through L1, the output row of the point is written as
// contiguous float2s, and 32 independent gathers per warp keep enough loads
// in flight to cover L2 latency.  Per-level constants come by value.
//
// K7: the table gradient, replacing pvd_tpu/ops/hashgrid.py:284
// _corner_gather_sum_bwd (hashed levels) and the autodiff of the packed
// dense gather (build_packed_dense, :420) for the dense levels:
//   g_table[offset_l + row(corner k)] += w_k * g[n, l]
// over the same 8 corners, rows and weights as K1 (the shared
// corner_setup below).  No gradient reaches x01: sample positions come from
// the march, so the JAX package's g_w term has no consumer here.
// One thread per (point, level) issues 16 fp32 atomicAdds (2 channels x 8
// corners) into a zeroed [T, 2] gradient.  Pairs whose upstream g is exactly
// (0, 0) return at once: on the padded [N, S] path most slots are invalid
// and the composite's backward gives them zero gradient.  Points outside
// [0, 1]^3 have zero weights and return too.
// Bound on the H100: memory.  Per (point, level) it reads 8 B of g and does
// 8 read-modify-writes of 8 B at scattered rows, plus the wrapper's 42 MB
// memset of the gradient.  The coarse dense levels (16^3 ...) and hash
// collisions put many atomics on few rows; the sums' order varies from run
// to run, so the card check uses a relative tolerance.
//
// K10: the cell-packed levels, replacing pvd_tpu/ops/hashgrid.py:332
// _cell_gather_sum with the rows of hash_encode's cell branch (:603-613).
// A cell level stores all 8 corners of a lattice cell in ONE 64-byte row of
// the [n_cell * 2^16, 16] cell table, corner-major (row[2k], row[2k+1] is
// corner k), hashed by the cell's base coordinate:
//   row = ((b0*1 ^ b1*2654435761 ^ b2*805459861) mod 2^32) & (2^16 - 1)
//         + cell_ordinal * 2^16
//   out = sum_k w_k * row[2k : 2k+2]
// with K1's corner_setup and corner_weight, so the weights are K1's bit for
// bit.  One thread per (point, cell level) reads its row as four float4
// loads and writes one float2.  Bound: memory, one 64-byte row per pair
// (two 32-byte sectors, all useful) against K1's eight scattered 8-byte rows;
// the 37.7 MB cell table fits the L2.
//
// K11: the cell table's gradient, replacing _cell_gather_sum_bwd (:362),
// the table part (no g_w, as in K7): row[2k : 2k+2] += w_k * g[n, l].
// One thread per (point, cell level) adds its 16 floats as four float4
// atomics where the toolkit has them for sm_90 (else 16 scalar atomics).
// Pairs with g = (0, 0) and points outside [0, 1]^3 return first, as in
// K7.  Bound: memory, the wrapper's dense 37.7 MB zeroed gradient (AdamW
// updates every row, as optax does) plus one 64-byte read-modify-write per
// active pair; order varies from run to run (atomics), so the card check
// uses a relative tolerance.

// K12: the D = 2 encode, replacing pvd_tpu/ops/hashgrid.py:533 hash_encode
// at input_dim 2 as pvd_tpu/models/api.py:127 background_rgb calls it: the
// polar coordinates of the background sphere, (polar + 1) / 2 in [0, 1]^2,
// on bg_grid_spec's 4 levels x 2 channels (resolutions 16/81/407/2048:
// levels 0-2 dense and row-major, c0 + c1 * side; level 3 hashed,
// (c0 * 1 ^ c1 * 2654435761) & (2^19 - 1)), a 697,776 x 2 table (5.6 MB).
// It is K1's body instantiated at D = 2: the same x01 * scale + 0.5 FMA,
// bilinear weights over 4 corners and the same per-(point, level) thread;
// inputs outside [0, 1]^2 give 0.  Bound on the H100: memory, 4 rows of
// 8 B per (point, level) from a table that fits the L2, 8 B read and 32 B
// written per point; one launch per composited batch, on N rays, not on
// the samples, so it is small beside K1.
//
// K13: its table gradient, K7's body at D = 2: fp32 atomicAdd of w * g into
// a zeroed dense [697,776, 2] gradient, one per corner and channel (8 per
// (point, level)); pairs with g = (0, 0) and points outside the square exit
// first.  Bound: memory, the wrapper's 5.6 MB zero-fill plus 4 scattered
// read-modify-writes of 8 B per active pair.  The coarse dense levels (17^2
// vertices at level 0) put many rays' atomics on few rows; the order of the
// sums varies from run to run, so the card check uses a relative tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#define PVD_MAX_LEVELS 32

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 2))
#define PVD_VECTOR_ATOMICS 1
#else
#define PVD_VECTOR_ATOMICS 0
#endif

struct HashLevels {
  int n_levels;    // entries of this launch
  int out_levels;  // level slots in a row of the output / upstream gradient
  uint32_t hash_mask;
  int level[PVD_MAX_LEVELS];   // slot of entry i in the row
  int offset[PVD_MAX_LEVELS];  // first table row of entry i
  int side[PVD_MAX_LEVELS];
  int hashed[PVD_MAX_LEVELS];
  float scale[PVD_MAX_LEVELS];
};

// Corner setup of one (point, level entry) of a D-dimensional grid: lattice
// base, fractions and level constants, computed exactly as the plain
// version does.
template <int D>
struct Corners {
  float f[D], g[D];  // fractions and 1 - fractions
  uint32_t i[D];     // lattice base
  uint32_t side;
  bool hashed;
};

template <int D>
__device__ __forceinline__ void load_point(const float* __restrict__ x01,
                                           long long n, float (&x)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = __ldg(x01 + D * n + d);
}

template <int D>
__device__ __forceinline__ Corners<D> corner_setup(const float (&x)[D], int l,
                                                   const HashLevels& lv) {
  Corners<D> c;
  const float s = lv.scale[l];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = __fmaf_rn(x[d], s, 0.5f);
    const float b = floorf(p);
    c.f[d] = __fsub_rn(p, b);
    c.g[d] = __fsub_rn(1.f, c.f[d]);
    c.i[d] = (uint32_t)(int)b;
  }
  c.side = (uint32_t)lv.side[l];
  c.hashed = lv.hashed[l] != 0;
  return c;
}

// Weight of corner k (bit d of k: +1 along dim d), multiplied left to right
// over the dimensions.
template <int D>
__device__ __forceinline__ float corner_weight(const Corners<D>& c, int k) {
  float w = (k & 1) ? c.f[0] : c.g[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    w = __fmul_rn(w, ((k >> d) & 1) ? c.f[d] : c.g[d]);
  return w;
}

__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

// Level-relative row of corner k: the xor-prime hash (mod 2^32) & mask on a
// hashed level, row-major c0 + c1 * side + c2 * side^2 on a dense one.
template <int D>
__device__ __forceinline__ uint32_t corner_row(const Corners<D>& c, int k,
                                               uint32_t hash_mask) {
  uint32_t h = 0u, r = 0u, stride = 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const uint32_t cd = c.i[d] + ((k >> d) & 1);
    h ^= cd * prime(d);
    r += cd * stride;
    stride *= c.side;
  }
  return c.hashed ? (h & hash_mask) : r;
}

// (x < 0) | (x > 1) in any dimension, as in hashgrid.py:571 (a NaN passes,
// like JAX's)
template <int D>
__device__ __forceinline__ bool outside(const float (&x)[D]) {
  bool o = false;
#pragma unroll
  for (int d = 0; d < D; ++d) o = o || x[d] < 0.f || x[d] > 1.f;
  return o;
}

// K1 (D = 3) and K12 (D = 2): one thread per (point, level entry).
template <int D>
__device__ __forceinline__ void encode_fwd(const float* __restrict__ x01,
                                           const float2* __restrict__ table,
                                           float2* __restrict__ out,
                                           long long n_points,
                                           const HashLevels& lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  float2* o = out + n * lv.out_levels + lv.level[l];
  float x[D];
  load_point<D>(x01, n, x);
  if (outside<D>(x)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners<D> c = corner_setup<D>(x, l, lv);
  const float2* tl = table + lv.offset[l];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    const float w = corner_weight<D>(c, k);
    const float2 v = __ldg(tl + corner_row<D>(c, k, lv.hash_mask));
    a0 = __fmaf_rn(w, v.x, a0);
    a1 = __fmaf_rn(w, v.y, a1);
  }
  *o = make_float2(a0, a1);
}

// K7 (D = 3) and K13 (D = 2): 2 * 2^D fp32 atomics per active pair.
template <int D>
__device__ __forceinline__ void encode_bwd(const float* __restrict__ x01,
                                           const float2* __restrict__ g,
                                           float* __restrict__ grad,
                                           long long n_points,
                                           const HashLevels& lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  const float2 gv = g[n * lv.out_levels + lv.level[l]];
  if (gv.x == 0.f && gv.y == 0.f) return;
  float x[D];
  load_point<D>(x01, n, x);
  if (outside<D>(x)) return;
  const Corners<D> c = corner_setup<D>(x, l, lv);
  float* gl = grad + 2 * (long long)lv.offset[l];
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    const float w = corner_weight<D>(c, k);
    float* dst = gl + 2 * (long long)corner_row<D>(c, k, lv.hash_mask);
    atomicAdd(dst, __fmul_rn(w, gv.x));
    atomicAdd(dst + 1, __fmul_rn(w, gv.y));
  }
}

__global__ void hash_encode_fwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ table,
                                       float2* __restrict__ out,
                                       long long n_points, HashLevels lv) {
  encode_fwd<3>(x01, table, out, n_points, lv);
}

__global__ void hash_encode_bwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ g,
                                       float* __restrict__ grad,
                                       long long n_points, HashLevels lv) {
  encode_bwd<3>(x01, g, grad, n_points, lv);
}

__global__ void hash_encode2_fwd_kernel(const float* __restrict__ x01,
                                        const float2* __restrict__ table,
                                        float2* __restrict__ out,
                                        long long n_points, HashLevels lv) {
  encode_fwd<2>(x01, table, out, n_points, lv);
}

__global__ void hash_encode2_bwd_kernel(const float* __restrict__ x01,
                                        const float2* __restrict__ g,
                                        float* __restrict__ grad,
                                        long long n_points, HashLevels lv) {
  encode_bwd<2>(x01, g, grad, n_points, lv);
}

// The cell row of one (point, cell level entry): corner 0's hashed row
// (the cell's base coordinate) plus the entry's block of the cell table.
__device__ __forceinline__ long long cell_row(const Corners<3>& c, int l,
                                              const HashLevels& lv) {
  return (long long)lv.offset[l] + corner_row<3>(c, 0, lv.hash_mask);
}

__global__ void hash_cell_fwd_kernel(const float* __restrict__ x01,
                                     const float4* __restrict__ cell,
                                     float2* __restrict__ out,
                                     long long n_points, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  float2* o = out + n * lv.out_levels + lv.level[l];
  float x[3];
  load_point<3>(x01, n, x);
  if (outside<3>(x)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners<3> c = corner_setup<3>(x, l, lv);
  const float4* r = cell + 4 * cell_row(c, l, lv);
  const float4 v[4] = {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight<3>(c, 2 * q);
    const float w1 = corner_weight<3>(c, 2 * q + 1);
    a0 = __fmaf_rn(w0, v[q].x, a0);
    a1 = __fmaf_rn(w0, v[q].y, a1);
    a0 = __fmaf_rn(w1, v[q].z, a0);
    a1 = __fmaf_rn(w1, v[q].w, a1);
  }
  *o = make_float2(a0, a1);
}

__global__ void hash_cell_bwd_kernel(const float* __restrict__ x01,
                                     const float2* __restrict__ g,
                                     float4* __restrict__ grad,
                                     long long n_points, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  const float2 gv = g[n * lv.out_levels + lv.level[l]];
  if (gv.x == 0.f && gv.y == 0.f) return;
  float x[3];
  load_point<3>(x01, n, x);
  if (outside<3>(x)) return;
  const Corners<3> c = corner_setup<3>(x, l, lv);
  float4* dst = grad + 4 * cell_row(c, l, lv);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight<3>(c, 2 * q);
    const float w1 = corner_weight<3>(c, 2 * q + 1);
    const float4 add = make_float4(__fmul_rn(w0, gv.x), __fmul_rn(w0, gv.y),
                                   __fmul_rn(w1, gv.x), __fmul_rn(w1, gv.y));
#if PVD_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(dst + q, add);
#else
    float* d = reinterpret_cast<float*>(dst + q);
    atomicAdd(d, add.x);
    atomicAdd(d + 1, add.y);
    atomicAdd(d + 2, add.z);
    atomicAdd(d + 3, add.w);
#endif
  }
}

static long long n_blocks(long long n_points, const HashLevels& lv,
                          int threads) {
  return (n_points * lv.n_levels + threads - 1) / threads;
}

extern "C" int pvd_hash_encode_fwd(const float* x01, const float* table,
                                   float* out, long long n_points,
                                   HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_encode_fwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads), threads,
                           0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_encode_bwd(const float* x01, const float* g,
                                   float* grad_table, long long n_points,
                                   HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_encode_bwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads), threads,
                           0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(g), grad_table, n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_encode2_fwd(const float* x01, const float* table,
                                    float* out, long long n_points,
                                    HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_encode2_fwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads),
                            threads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_encode2_bwd(const float* x01, const float* g,
                                    float* grad_table, long long n_points,
                                    HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_encode2_bwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads),
                            threads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(g), grad_table, n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_cell_fwd(const float* x01, const float* cell_table,
                                 float* out, long long n_points, HashLevels lv,
                                 void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_cell_fwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads), threads, 0,
                         (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float4*>(cell_table),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_cell_bwd(const float* x01, const float* g,
                                 float* grad_cell, long long n_points,
                                 HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_cell_bwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads), threads, 0,
                         (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(g),
      reinterpret_cast<float4*>(grad_cell), n_points, lv);
  return (int)cudaGetLastError();
}

// 1 when K11 was built with float4 atomics, 0 with scalar ones.
extern "C" int pvd_hash_cell_vector_atomics() { return PVD_VECTOR_ATOMICS; }
