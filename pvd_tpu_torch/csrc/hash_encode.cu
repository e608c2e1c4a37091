// K1: multi-resolution hash-grid encode (INGP), forward, D = 3, C = 2.
//
// Replaces pvd_tpu/ops/hashgrid.py:533 hash_encode in exact mode: the
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
// Bound on the H100: memory.  Each (point, level) reads 8 rows of 8 B at
// scattered addresses (32-byte sectors, so ~4x the useful bytes) and writes
// 8 B.  At the full INGP config the whole table is 5.3M rows x 8 B = 42 MB,
// which fits the 50 MB L2, so the scattered reads are mostly L2 hits after
// the first touch.  Design: one thread per (point, level), level fastest,
// so a warp covers ~2 points across all levels: the point's 12 bytes are
// read once per warp through L1, the output row of the point is written as
// contiguous float2s, and 32 independent gathers per warp keep enough loads
// in flight to cover L2 latency.  Per-level constants come by value.

#include <cuda_runtime.h>
#include <stdint.h>

#define PVD_MAX_LEVELS 32

struct HashLevels {
  int n_levels;
  uint32_t hash_mask;
  int offset[PVD_MAX_LEVELS];
  int side[PVD_MAX_LEVELS];
  int hashed[PVD_MAX_LEVELS];
  float scale[PVD_MAX_LEVELS];
};

__global__ void hash_encode_fwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ table,
                                       float2* __restrict__ out,
                                       long long n_points, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  const float x = __ldg(x01 + 3 * n);
  const float y = __ldg(x01 + 3 * n + 1);
  const float z = __ldg(x01 + 3 * n + 2);
  // (x < 0) | (x > 1) as in hashgrid.py:571 (a NaN passes, like JAX's)
  if (x < 0.f || x > 1.f || y < 0.f || y > 1.f || z < 0.f || z > 1.f) {
    out[gid] = make_float2(0.f, 0.f);
    return;
  }
  const float s = lv.scale[l];
  const float px = __fmaf_rn(x, s, 0.5f);
  const float py = __fmaf_rn(y, s, 0.5f);
  const float pz = __fmaf_rn(z, s, 0.5f);
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  const float fx = __fsub_rn(px, bx), fy = __fsub_rn(py, by),
              fz = __fsub_rn(pz, bz);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy),
              gz = __fsub_rn(1.f, fz);
  const uint32_t ix = (uint32_t)(int)bx, iy = (uint32_t)(int)by,
                 iz = (uint32_t)(int)bz;
  const uint32_t side = (uint32_t)lv.side[l];
  const bool hashed = lv.hashed[l] != 0;
  const float2* tl = table + lv.offset[l];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t dx = k & 1, dy = (k >> 1) & 1, dz = (k >> 2) & 1;
    const float w = __fmul_rn(__fmul_rn(dx ? fx : gx, dy ? fy : gy),
                              dz ? fz : gz);
    const uint32_t cx = ix + dx, cy = iy + dy, cz = iz + dz;
    const uint32_t row =
        hashed ? ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) &
                     lv.hash_mask
               : cx + cy * side + cz * side * side;
    const float2 v = __ldg(tl + row);
    a0 = __fmaf_rn(w, v.x, a0);
    a1 = __fmaf_rn(w, v.y, a1);
  }
  out[gid] = make_float2(a0, a1);
}

extern "C" int pvd_hash_encode_fwd(const float* x01, const float* table,
                                   float* out, long long n_points,
                                   HashLevels lv, void* stream) {
  if (n_points == 0) return 0;
  const long long total = n_points * lv.n_levels;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hash_encode_fwd_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}
