// Designs of K12 (the background's 2-D hash encode) and K15 (the baked
// dense levels' encode) timed against the shipped kernels by
// tools/torch_k12_k15_rounds.py and dropped (their times are in
// hash_encode.cu's notes); the shipped ones are in
// pvd_tpu_torch/csrc/hash_encode.cu, whose helpers this file includes.
// Every design keeps the shipped arithmetic (corner_setup and
// corner_weight, or the lean lattice that gives the same bits, and the FMA
// chain over corners k = 0..7 in order), so each output equals the plain
// version's up to the order the plain version sums in.
//
//   cand_k12(variant, threads, ...):
//     0  the first design (a thread per (point, level), level fastest, the
//        shipped K12's body), `threads` a block;
//     1  K1's redesigned body at D = 2: a thread per point and pair of
//        levels, the lattice without float-to-int, a thread's 8 loads
//        issued together, rows staged in shared memory and written as each
//        point's 32-byte run (64 points a block; `threads` unused);
//     2  a thread per point over all 4 levels: x01 read as one float2, 16
//        row loads in flight, the 32-byte row stored as two float4s,
//        `threads` points a block;
//     3  the first design's thread per (point, level) without its 64-bit
//        division and runtime-indexed level constants, with the lean
//        lattice, `threads` a block.
//   cand_k15(variant, points, ...):
//     0  (point, corner) lanes: 8 lanes a point, lane pairs loading a run
//        of two adjacent vertex rows with consecutive float2s, the rows and
//        weights staged in shared memory, then (point, level) lanes running
//        the FMA chain and writing each point's slots as one run, `points`
//        a block;
//     1  the shipped K15's body (a thread per (point, level), level
//        fastest, a block of (Ld, `points`) threads) at other block sizes
//        than its K15_POINTS.

#include "../pvd_tpu_torch/csrc/hash_encode.cu"

#define CAND_K12_LEVELS 4

// K1's lean lattice at D = 2 (k1_level's rules): rows and weights of the
// point at x inside [0, 1]^2 on a level of scale s and side `side`.
__device__ __forceinline__ void cand_k12_lattice(const float (&x)[2], float s,
                                                 uint32_t side, bool hashed,
                                                 uint32_t m,
                                                 uint32_t (&row)[4],
                                                 float (&w)[4]) {
  float f[2], g[2];
  uint32_t c[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float pos = __fmaf_rn(x[d], s, 0.5f);
    const float r = __fadd_rd(pos, 8388608.f);
    f[d] = __fsub_rn(pos, __fsub_rn(r, 8388608.f));
    g[d] = __fsub_rn(1.f, f[d]);
    c[d] = __float_as_uint(r) & 0x7fffffu;
  }
  uint32_t ax[2], ay[2];
  if (hashed) {
    const uint32_t hy = c[1] * 2654435761u;
    ax[0] = c[0] & m;
    ax[1] = (c[0] + 1u) & m;
    ay[0] = hy & m;
    ay[1] = (hy + 2654435761u) & m;
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = ax[k & 1] ^ ay[k >> 1];
  } else {
    ax[0] = c[0];
    ax[1] = c[0] + 1u;
    ay[0] = c[1] * side;
    ay[1] = ay[0] + side;
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = ax[k & 1] + ay[k >> 1];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = __fmul_rn((k & 1) ? f[0] : g[0], (k & 2) ? f[1] : g[1]);
}

__device__ __forceinline__ void cand_k12_level(const float (&x)[2], int i,
                                               const HashLevels& lv,
                                               uint32_t (&row)[4],
                                               float (&w)[4]) {
  cand_k12_lattice(x, lv.scale[i], (uint32_t)lv.side[i], lv.hashed[i] != 0,
                   lv.hash_mask, row, w);
}

// variant 3: a thread per (point, level), level fastest as in the first
// design, but the level (gid & 3) and point (gid >> 2) without a 64-bit
// division, the level constants picked by selects of compile-time
// indices, the lean lattice; out's row is the 4 levels, so a warp stores
// 256 consecutive bytes
__global__ void cand_k12_lanes(const float* __restrict__ x01,
                               const float2* __restrict__ table,
                               float2* __restrict__ out, unsigned n_pairs,
                               HashLevels lv) {
  const unsigned gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_pairs) return;
  const int l = gid & 3;
  float x[2];
  load_point<2>(x01, gid >> 2, x);
  float z;
  if (nan_or_outside<2>(x, z)) {
    out[gid] = make_float2(z, z);
    return;
  }
  float s = lv.scale[0];
  int off = lv.offset[0], side = lv.side[0], hashed = lv.hashed[0];
#pragma unroll
  for (int i = 1; i < CAND_K12_LEVELS; ++i)
    if (l == i) {
      s = lv.scale[i];
      off = lv.offset[i];
      side = lv.side[i];
      hashed = lv.hashed[i];
    }
  uint32_t row[4];
  float w[4];
  cand_k12_lattice(x, s, (uint32_t)side, hashed != 0, lv.hash_mask, row, w);
  const float2* tl = table + off;
  float2 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __ldg(tl + row[k]);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a0 = __fmaf_rn(w[k], v[k].x, a0);
    a1 = __fmaf_rn(w[k], v[k].y, a1);
  }
  out[gid] = make_float2(a0, a1);
}

// variant 1: 64 points x 2 level pairs a block (128 threads)
__global__ void __launch_bounds__(128)
    cand_k12_pairs(const float* __restrict__ x01,
                   const float2* __restrict__ table, float2* __restrict__ out,
                   long long n_points, HashLevels lv) {
  __shared__ float2 tile[64 * (CAND_K12_LEVELS + 1)];
  const int p = threadIdx.x % 64, c = threadIdx.x / 64 * 2;
  const long long n0 = (long long)blockIdx.x * 64;
  if (n0 + p < n_points) {
    float x[2];
    load_point<2>(x01, n0 + p, x);
    float z;
    float2* t = tile + p * (CAND_K12_LEVELS + 1) + c;
    if (nan_or_outside<2>(x, z)) {
      t[0] = t[1] = make_float2(z, z);
    } else {
      uint32_t row[2][4];
      float w[2][4];
      float2 v[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) cand_k12_level(x, c + j, lv, row[j], w[j]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2* tl = table + lv.offset[c + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[j][k] = __ldg(tl + row[j][k]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a0 = __fmaf_rn(w[j][k], v[j][k].x, a0);
          a1 = __fmaf_rn(w[j][k], v[j][k].y, a1);
        }
        t[j] = make_float2(a0, a1);
      }
    }
  }
  __syncthreads();
  const int rows = (int)min(64LL, n_points - n0);
  float2* o = out + n0 * CAND_K12_LEVELS;
  for (int e = threadIdx.x; e < rows * CAND_K12_LEVELS; e += 128)
    o[e] = tile[(e / CAND_K12_LEVELS) * (CAND_K12_LEVELS + 1) +
                e % CAND_K12_LEVELS];
}

// variant 2: a thread per point, all 4 levels
__global__ void cand_k12_point(const float2* __restrict__ x01,
                               const float2* __restrict__ table,
                               float4* __restrict__ out, long long n_points,
                               HashLevels lv) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  const float2 xv = __ldg(x01 + n);
  const float x[2] = {xv.x, xv.y};
  float4* o = out + 2 * n;
  float z;
  if (nan_or_outside<2>(x, z)) {
    o[0] = o[1] = make_float4(z, z, z, z);
    return;
  }
  Corners<2> c[CAND_K12_LEVELS];
  float2 v[CAND_K12_LEVELS][4];
#pragma unroll
  for (int l = 0; l < CAND_K12_LEVELS; ++l) {
    c[l] = corner_setup<2>(x, l, lv);
    const float2* tl = table + lv.offset[l];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[l][k] = __ldg(tl + corner_row<2>(c[l], k, lv.hash_mask));
  }
  float r[2 * CAND_K12_LEVELS];
#pragma unroll
  for (int l = 0; l < CAND_K12_LEVELS; ++l) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = corner_weight<2>(c[l], k);
      a0 = __fmaf_rn(w, v[l][k].x, a0);
      a1 = __fmaf_rn(w, v[l][k].y, a1);
    }
    r[2 * l] = a0;
    r[2 * l + 1] = a1;
  }
  o[0] = make_float4(r[0], r[1], r[2], r[3]);
  o[1] = make_float4(r[4], r[5], r[6], r[7]);
}

// K15 variant 0: `points` points a block, 8 lanes a point (corner k =
// lane & 7) in the load phase, then (point, level) lanes.
__global__ void cand_k15_corners(const float* __restrict__ x01,
                                 const float2* __restrict__ baked,
                                 float2* __restrict__ out, long long n_points,
                                 HashLevels lv) {
  extern __shared__ float k15_stage[];
  const int ld = lv.n_levels, pts = blockDim.x / 8;
  float2* rows = reinterpret_cast<float2*>(k15_stage);  // [pts][8 * ld]
  float* ws = k15_stage + 2 * pts * 8 * ld;             // [pts][8]
  float* zs = ws + pts * 8;                             // [pts]
  const long long n0 = (long long)blockIdx.x * pts;
  {
    const int pl = threadIdx.x >> 3, k = threadIdx.x & 7;
    const long long n = n0 + pl;
    if (n < n_points) {
      float x[3], z;
      load_point<3>(x01, n, x);
      if (nan_or_outside<3>(x, z)) {
        if (k == 0) zs[pl] = z;
        ws[pl * 8 + k] = CUDART_NAN_F;  // marks the point
      } else {
        const Corners<3> c = corner_setup<3>(x, 0, lv);
        ws[pl * 8 + k] = corner_weight<3>(c, k);
        if (k == 0) zs[pl] = 0.f;
        // lanes 2m, 2m + 1 read the run of rows (corner 2m, corner 2m + 1)
        const int b = k & 1;
        const float2* run =
            baked + (long long)corner_row<3>(c, k & 6, 0u) * ld;
        float2* dst = rows + pl * 8 * ld + (k & 6) * ld;
#pragma unroll
        for (int i = 0; i < PVD_MAX_BAKED; ++i)
          if (i < ld) dst[2 * i + b] = __ldg(run + 2 * i + b);
      }
    }
  }
  __syncthreads();
  const int pairs = (int)min((long long)pts, n_points - n0) * ld;
  for (int u = threadIdx.x; u < pairs; u += blockDim.x) {
    const int pl = u / ld, j = u - pl * ld;
    float2* o = out + (n0 + pl) * lv.out_levels + lv.level[0] + j;
    const float* w = ws + pl * 8;
    if (isnan(w[0])) {
      const float z = zs[pl];
      *o = make_float2(z, z);
      continue;
    }
    const float2* r = rows + pl * 8 * ld + j;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 v = r[k * ld];
      a0 = __fmaf_rn(w[k], v.x, a0);
      a1 = __fmaf_rn(w[k], v.y, a1);
    }
    *o = make_float2(a0, a1);
  }
}

// The K12 candidates take the background grid's 4 levels in slots 0..3;
// the K15 ones consecutive dense slots.
extern "C" int cand_k12(int variant, int threads, const float* x01,
                        const float* table, float* out, long long n_points,
                        HashLevels lv, void* stream) {
  if (n_points == 0) return 0;
  bool ok = lv.n_levels == CAND_K12_LEVELS &&
            lv.out_levels == CAND_K12_LEVELS &&
            (uintptr_t)x01 % 8 == 0 && (uintptr_t)out % 16 == 0;
  for (int l = 0; ok && l < CAND_K12_LEVELS; ++l) ok = lv.level[l] == l;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* t = reinterpret_cast<const float2*>(table);
  if (variant == 0) {
    hash_encode2_fwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads),
                              threads, 0, s>>>(
        x01, t, reinterpret_cast<float2*>(out), n_points, lv);
  } else if (variant == 1) {
    cand_k12_pairs<<<(unsigned)((n_points + 63) / 64), 128, 0, s>>>(
        x01, t, reinterpret_cast<float2*>(out), n_points, lv);
  } else if (variant == 2) {
    cand_k12_point<<<(unsigned)((n_points + threads - 1) / threads), threads,
                     0, s>>>(reinterpret_cast<const float2*>(x01), t,
                             reinterpret_cast<float4*>(out), n_points, lv);
  } else if (variant == 3) {
    if (n_points >= (1LL << 30)) return (int)cudaErrorInvalidValue;
    const unsigned pairs = (unsigned)(4 * n_points);
    cand_k12_lanes<<<(pairs + threads - 1) / threads, threads, 0, s>>>(
        x01, t, reinterpret_cast<float2*>(out), pairs, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int cand_k15(int variant, int points, const float* x01,
                        const float* baked, float* out, long long n_points,
                        HashLevels lv, void* stream) {
  if (n_points == 0) return 0;
  const int ld = lv.n_levels;
  bool ok = ld >= 1 && ld <= PVD_MAX_BAKED &&
            lv.level[0] + ld <= lv.out_levels;
  for (int j = 1; ok && j < ld; ++j) ok = lv.level[j] == lv.level[0] + j;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* b = reinterpret_cast<const float2*>(baked);
  float2* o = reinterpret_cast<float2*>(out);
  const unsigned blocks = (unsigned)((n_points + points - 1) / points);
  if (variant == 0) {
    const size_t smem = (size_t)points * (8 * ld * 2 + 8 + 1) * 4;
    cand_k15_corners<<<blocks, 8 * points, smem, s>>>(x01, b, o, n_points,
                                                      lv);
  } else if (variant == 1) {
    hash_baked_fwd_kernel<<<blocks, dim3(ld, points), 0, s>>>(x01, b, o,
                                                              n_points, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
