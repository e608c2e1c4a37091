// K1: multi-resolution hash-grid encode (INGP), forward, D = 3, C = 2;
// K7: its table gradient;
// K10: the cell-packed levels' encode; K11: the cell table's gradient.
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

// Corner setup of one (point, level entry): lattice base, fractions and
// level constants, computed exactly as the plain version does.
struct Corners {
  float fx, fy, fz, gx, gy, gz;
  uint32_t ix, iy, iz, side;
  bool hashed;
};

__device__ __forceinline__ Corners corner_setup(float x, float y, float z,
                                                int l, const HashLevels& lv) {
  Corners c;
  const float s = lv.scale[l];
  const float px = __fmaf_rn(x, s, 0.5f);
  const float py = __fmaf_rn(y, s, 0.5f);
  const float pz = __fmaf_rn(z, s, 0.5f);
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  c.fx = __fsub_rn(px, bx);
  c.fy = __fsub_rn(py, by);
  c.fz = __fsub_rn(pz, bz);
  c.gx = __fsub_rn(1.f, c.fx);
  c.gy = __fsub_rn(1.f, c.fy);
  c.gz = __fsub_rn(1.f, c.fz);
  c.ix = (uint32_t)(int)bx;
  c.iy = (uint32_t)(int)by;
  c.iz = (uint32_t)(int)bz;
  c.side = (uint32_t)lv.side[l];
  c.hashed = lv.hashed[l] != 0;
  return c;
}

// Weight and level-relative row of corner k (bit d of k: +1 along dim d).
__device__ __forceinline__ float corner_weight(const Corners& c, int k) {
  return __fmul_rn(__fmul_rn((k & 1) ? c.fx : c.gx, (k & 2) ? c.fy : c.gy),
                   (k & 4) ? c.fz : c.gz);
}

__device__ __forceinline__ uint32_t corner_row(const Corners& c, int k,
                                               uint32_t hash_mask) {
  const uint32_t cx = c.ix + (k & 1), cy = c.iy + ((k >> 1) & 1),
                 cz = c.iz + ((k >> 2) & 1);
  return c.hashed
             ? ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & hash_mask
             : cx + cy * c.side + cz * c.side * c.side;
}

// (x < 0) | (x > 1) as in hashgrid.py:571 (a NaN passes, like JAX's)
__device__ __forceinline__ bool outside(float x, float y, float z) {
  return x < 0.f || x > 1.f || y < 0.f || y > 1.f || z < 0.f || z > 1.f;
}

__global__ void hash_encode_fwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ table,
                                       float2* __restrict__ out,
                                       long long n_points, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  float2* o = out + n * lv.out_levels + lv.level[l];
  const float x = __ldg(x01 + 3 * n);
  const float y = __ldg(x01 + 3 * n + 1);
  const float z = __ldg(x01 + 3 * n + 2);
  if (outside(x, y, z)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners c = corner_setup(x, y, z, l, lv);
  const float2* tl = table + lv.offset[l];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(c, k);
    const float2 v = __ldg(tl + corner_row(c, k, lv.hash_mask));
    a0 = __fmaf_rn(w, v.x, a0);
    a1 = __fmaf_rn(w, v.y, a1);
  }
  *o = make_float2(a0, a1);
}

__global__ void hash_encode_bwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ g,
                                       float* __restrict__ grad,
                                       long long n_points, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  const float2 gv = g[n * lv.out_levels + lv.level[l]];
  if (gv.x == 0.f && gv.y == 0.f) return;
  const float x = __ldg(x01 + 3 * n);
  const float y = __ldg(x01 + 3 * n + 1);
  const float z = __ldg(x01 + 3 * n + 2);
  if (outside(x, y, z)) return;
  const Corners c = corner_setup(x, y, z, l, lv);
  float* gl = grad + 2 * (long long)lv.offset[l];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(c, k);
    float* dst = gl + 2 * (long long)corner_row(c, k, lv.hash_mask);
    atomicAdd(dst, __fmul_rn(w, gv.x));
    atomicAdd(dst + 1, __fmul_rn(w, gv.y));
  }
}

// The cell row of one (point, cell level entry): corner 0's hashed row
// (the cell's base coordinate) plus the entry's block of the cell table.
__device__ __forceinline__ long long cell_row(const Corners& c, int l,
                                              const HashLevels& lv) {
  return (long long)lv.offset[l] + corner_row(c, 0, lv.hash_mask);
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
  const float x = __ldg(x01 + 3 * n);
  const float y = __ldg(x01 + 3 * n + 1);
  const float z = __ldg(x01 + 3 * n + 2);
  if (outside(x, y, z)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners c = corner_setup(x, y, z, l, lv);
  const float4* r = cell + 4 * cell_row(c, l, lv);
  const float4 v[4] = {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight(c, 2 * q), w1 = corner_weight(c, 2 * q + 1);
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
  const float x = __ldg(x01 + 3 * n);
  const float y = __ldg(x01 + 3 * n + 1);
  const float z = __ldg(x01 + 3 * n + 2);
  if (outside(x, y, z)) return;
  const Corners c = corner_setup(x, y, z, l, lv);
  float4* dst = grad + 4 * cell_row(c, l, lv);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight(c, 2 * q), w1 = corner_weight(c, 2 * q + 1);
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
