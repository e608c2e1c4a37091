// Designs of K8 (the padded composite's forward) and K16 (the bake of a
// frozen table) timed against the shipped kernels by
// tools/torch_k8_k16_rounds.py, and the first designs they replaced; the
// shipped ones are in pvd_tpu_torch/csrc/composite.cu and hash_encode.cu,
// which this file includes.  No design here is on a path of the package;
// their times are in the shipped kernels' notes (composite.cu,
// hash_encode.cu) and PERF.md §6.
//
// Every design keeps each output's arithmetic, so its K8 weights and its
// K16 table equal the first design's bit for bit: K8's alpha
// 1 - exp(-sigma dt) and T as the serial product in slot order, w = alpha
// * T; K16's w = (wx * wy) * wz and acc + row * w over the corners k = dx +
// 2 dy + 4 dz, each product and sum rounded on its own.
//
//   cand_k8(variant, ...):
//     0  the first design: a thread per ray, blocks of 64, walking its S
//        slots in order with every slot's inputs loaded, masked or not;
//     1  the shipped body, a warp a ray, one tile's loads at a time;
//     2  the shipped body at 16 lanes a ray, 96 slots' loads together;
//     3  the shipped body at 16 lanes a ray, one tile's loads at a time;
//     4  the shipped body with 2 tiles' loads together.
//   cand_k16(variant, threads, ...):
//     0  the first design: a thread per (fine vertex, dense level), level
//        fastest, over a flat grid (a 64-bit division and remainder a
//        thread), `threads` a block (256 shipped);
//     1  (b) the first design's mapping on a 3-D grid: a block of (Ld,
//        `threads`) threads, level fastest, over (x chunk, y, z), so no
//        division;
//     2  (a) the shipped body (a block per fine row) at `threads` a block
//        (64, 128 or 256);
//     3, 4  (a) with a thread's base and fraction loads issued before the
//        block's level terms are ready and 2 (3) of its (level, vertex)
//        entries' loads issued at once, `threads` (64, 128, 256) a block;
//     5  (c) (a) with each coarse level's four x-lines of the row's cell
//        staged in shared memory first, `threads` (64, 128, 256) a block.
//   Every (a), (b) and (c) design reads the per-level constants of the
//   by-value lv with compile-time indices but (b), which keeps the first
//   design's body.

#include "../pvd_tpu_torch/csrc/composite.cu"
#include "../pvd_tpu_torch/csrc/hash_encode.cu"

__global__ void k8_first_design_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ dds,
    const uint8_t* __restrict__ mask, int n_rays, int S, int early_stop,
    float* __restrict__ weights, float* __restrict__ ws_out,
    float* __restrict__ depth_out, float* __restrict__ image_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long base = (long long)r * S;
  float T = 1.f, ws = 0.f, depth = 0.f, t_cum = 0.f, c0 = 0.f, c1 = 0.f,
        c2 = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = base + s;
    const bool m = mask[i] != 0;
    const float alpha =
        m ? __fsub_rn(1.f, expf(__fmul_rn(-sigmas[i], dts[i]))) : 0.f;
    t_cum = __fadd_rn(t_cum, m ? dds[i] : 0.f);
    const float w = (early_stop && T < 1e-4f) ? 0.f : __fmul_rn(alpha, T);
    weights[i] = w;
    ws = __fadd_rn(ws, w);
    depth = __fmaf_rn(w, t_cum, depth);
    c0 = __fmaf_rn(w, rgbs[3 * i], c0);
    c1 = __fmaf_rn(w, rgbs[3 * i + 1], c1);
    c2 = __fmaf_rn(w, rgbs[3 * i + 2], c2);
    T = __fmul_rn(T, __fsub_rn(1.f, alpha));
  }
  ws_out[r] = ws;
  depth_out[r] = depth;
  image_out[3 * r] = c0;
  image_out[3 * r + 1] = c1;
  image_out[3 * r + 2] = c2;
}

template <int G, int C>
static int cand_k8_groups(const float* sigmas, const float* rgbs,
                          const float* dt, const float* dd,
                          const uint8_t* mask, int n_rays, int S,
                          int early_stop, float* weights, float* ws,
                          float* depth, float* image, cudaStream_t st) {
  const long long blocks = ((long long)n_rays * G + K8_THREADS - 1) /
                           K8_THREADS;
  composite_padded_fwd_kernel<G, C><<<(unsigned)blocks, K8_THREADS, 0, st>>>(
      sigmas, rgbs, dt, dd, mask, n_rays, S, early_stop, weights, ws, depth,
      image);
  return (int)cudaGetLastError();
}

extern "C" int cand_k8(int variant, const float* sigmas, const float* rgbs,
                       const float* dt, const float* dd, const uint8_t* mask,
                       int n_rays, int S, int early_stop, float* weights,
                       float* ws, float* depth, float* image, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      k8_first_design_kernel<<<(n_rays + 63) / 64, 64, 0, st>>>(
          sigmas, rgbs, dt, dd, mask, n_rays, S, early_stop, weights, ws,
          depth, image);
      return (int)cudaGetLastError();
    case 1:
      return cand_k8_groups<32, 1>(sigmas, rgbs, dt, dd, mask, n_rays, S,
                                   early_stop, weights, ws, depth, image,
                                   st);
    case 2:
      return cand_k8_groups<16, 6>(sigmas, rgbs, dt, dd, mask, n_rays, S,
                                   early_stop, weights, ws, depth, image,
                                   st);
    case 3:
      return cand_k8_groups<16, 1>(sigmas, rgbs, dt, dd, mask, n_rays, S,
                                   early_stop, weights, ws, depth, image,
                                   st);
    case 4:
      return cand_k8_groups<32, 2>(sigmas, rgbs, dt, dd, mask, n_rays, S,
                                   early_stop, weights, ws, depth, image,
                                   st);
  }
  return (int)cudaErrorInvalidValue;
}

// K16's first design
__global__ void k16_first_design_kernel(const float2* __restrict__ table,
                                        const int* __restrict__ b,
                                        const float* __restrict__ f,
                                        float2* __restrict__ baked,
                                        int side_f, HashLevels lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vert = (long long)side_f * side_f * side_f;
  const int ld = lv.n_levels;
  if (gid >= n_vert * ld) return;
  const long long v = gid / ld;
  const int j = (int)(gid - v * ld);
  const float2* tl = table + lv.offset[j];
  if (j == ld - 1) {  // the finest dense level: its own vertex
    baked[gid] = __ldg(tl + v);
    return;
  }
  const int ix[3] = {(int)(v % side_f), (int)((v / side_f) % side_f),
                     (int)(v / ((long long)side_f * side_f))};
  int bs[3];
  float fs[3], gs[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    bs[d] = __ldg(b + j * side_f + ix[d]);
    fs[d] = __ldg(f + j * side_f + ix[d]);
    gs[d] = __fsub_rn(1.f, fs[d]);
  }
  const long long s = lv.side[j];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = (k >> 2) & 1;
    const float w = __fmul_rn(__fmul_rn(dx ? fs[0] : gs[0],
                                        dy ? fs[1] : gs[1]),
                              dz ? fs[2] : gs[2]);
    const float2 t = __ldg(tl + (bs[0] + dx) + (bs[1] + dy) * s
                           + (bs[2] + dz) * s * s);
    a0 = __fadd_rn(a0, __fmul_rn(t.x, w));
    a1 = __fadd_rn(a1, __fmul_rn(t.y, w));
  }
  baked[gid] = make_float2(a0, a1);
}

// (b): the first design's body with (x, y, z) from a 3-D grid and the
// level from threadIdx.x
__global__ void k16_grid3_kernel(const float2* __restrict__ table,
                                 const int* __restrict__ b,
                                 const float* __restrict__ f,
                                 float2* __restrict__ baked, int side_f,
                                 HashLevels lv) {
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  if (x >= side_f) return;
  const int y = blockIdx.y, zz = blockIdx.z, ld = lv.n_levels;
  const int j = threadIdx.x;
  const long long v = ((long long)zz * side_f + y) * side_f + x;
  const long long gid = v * ld + j;
  const float2* tl = table + lv.offset[j];
  if (j == ld - 1) {
    baked[gid] = __ldg(tl + v);
    return;
  }
  const int ix[3] = {x, y, zz};
  int bs[3];
  float fs[3], gs[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    bs[d] = __ldg(b + j * side_f + ix[d]);
    fs[d] = __ldg(f + j * side_f + ix[d]);
    gs[d] = __fsub_rn(1.f, fs[d]);
  }
  const long long s = lv.side[j];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = (k >> 2) & 1;
    const float w = __fmul_rn(__fmul_rn(dx ? fs[0] : gs[0],
                                        dy ? fs[1] : gs[1]),
                              dz ? fs[2] : gs[2]);
    const float2 t = __ldg(tl + (bs[0] + dx) + (bs[1] + dy) * s
                           + (bs[2] + dz) * s * s);
    a0 = __fadd_rn(a0, __fmul_rn(t.x, w));
    a1 = __fadd_rn(a1, __fmul_rn(t.y, w));
  }
  baked[gid] = make_float2(a0, a1);
}

// (a) with U entries' loads issued at once
template <int THREADS, int U>
__global__ void __launch_bounds__(THREADS) k16_entries_kernel(
    const float2* __restrict__ table, const int* __restrict__ b,
    const float* __restrict__ f, float2* __restrict__ baked, int side_f,
    HashLevels lv) {
  extern __shared__ float2 k16e_row[];  // [side_f][ld]
  __shared__ long long k16e_base[PVD_MAX_LEVELS];
  __shared__ int k16e_side[PVD_MAX_LEVELS];
  __shared__ float k16e_w[PVD_MAX_LEVELS][4];  // 1 - fy, fy, 1 - fz, fz
  const int ld = lv.n_levels, y = blockIdx.x, z = blockIdx.y;
  const int n = side_f * ld, t = threadIdx.x;
  if (t < ld) {  // THREADS >= 32 >= ld
    // the level's constants by compile-time index (a runtime index would
    // copy the by-value lv to local memory)
    long long off = 0, s = 0;
#pragma unroll
    for (int k = 0; k < PVD_MAX_LEVELS; ++k)
      if (k == t) {
        off = lv.offset[k];
        s = lv.side[k];
      }
    const int by = __ldg(b + t * side_f + y), bz = __ldg(b + t * side_f + z);
    const float fy = __ldg(f + t * side_f + y), fz = __ldg(f + t * side_f + z);
    k16e_base[t] = off + (long long)by * s + (long long)bz * s * s;
    k16e_side[t] = (int)s;
    k16e_w[t][0] = __fsub_rn(1.f, fy);
    k16e_w[t][1] = fy;
    k16e_w[t][2] = __fsub_rn(1.f, fz);
    k16e_w[t][3] = fz;
  }
  for (int e0 = 0; e0 < n; e0 += U * THREADS) {
    // entry e is (level j, vertex x) = (e / side_f, e % side_f), and b and
    // f are [Ld, side_f]: its x base and fraction are b[e], f[e] (the
    // finest level's base is x itself)
    int bx[U], jx[U];
    float fx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS + t;
      bx[u] = jx[u] = 0;
      fx[u] = 0.f;
      if (e < n) {
        bx[u] = __ldg(b + e);
        fx[u] = __ldg(f + e);
        jx[u] = e / side_f;
      }
    }
    if (e0 == 0) __syncthreads();  // the level terms
    float2 c[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jx[u];
      if (e0 + u * THREADS + t >= n) continue;
      const float2* row = table + k16e_base[j] + bx[u];
      if (j == ld - 1) {  // the finest dense level: its own vertex
        c[u][0] = __ldg(row);
        continue;
      }
      const long long s = k16e_side[j];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[u][k] = __ldg(row + (k & 1) + ((k >> 1) & 1) * s
                        + ((k >> 2) & 1) * s * s);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS + t, j = jx[u];
      if (e >= n) continue;
      float2 v = c[u][0];
      if (j != ld - 1) {
        const float wx[2] = {__fsub_rn(1.f, fx[u]), fx[u]};
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float w = __fmul_rn(
              __fmul_rn(wx[k & 1], k16e_w[j][(k >> 1) & 1]),
              k16e_w[j][2 + ((k >> 2) & 1)]);
          a0 = __fadd_rn(a0, __fmul_rn(c[u][k].x, w));
          a1 = __fadd_rn(a1, __fmul_rn(c[u][k].y, w));
        }
        v = make_float2(a0, a1);
      }
      k16e_row[(e - j * side_f) * ld + j] = v;
    }
  }
  __syncthreads();
  float2* dst = baked + ((long long)z * side_f + y) * side_f * ld;
  for (int e = t; e < n; e += THREADS) dst[e] = k16e_row[e];
}

// (c): (a) with each coarse level's four x-lines of the row's (y, z) cell,
// (by + dy, bz + dz), copied into shared memory first (coalesced), so the
// 8 corner reads of an entry come from shared memory; the finest level's
// row is copied straight into the staged row
template <int THREADS>
__global__ void __launch_bounds__(THREADS) k16_lines_kernel(
    const float2* __restrict__ table, const int* __restrict__ b,
    const float* __restrict__ f, float2* __restrict__ baked, int side_f,
    HashLevels lv) {
  extern __shared__ float2 k16c_smem[];  // [side_f][ld] row, then lines
  __shared__ long long c_base[PVD_MAX_LEVELS];
  __shared__ int c_side[PVD_MAX_LEVELS], c_line[PVD_MAX_LEVELS];
  __shared__ float c_w[PVD_MAX_LEVELS][4];
  float2* row = k16c_smem;
  float2* lines = k16c_smem + side_f * lv.n_levels;
  const int ld = lv.n_levels, y = blockIdx.x, z = blockIdx.y;
  const int t = threadIdx.x;
  if (t < ld) {
    long long off = 0, s = 0;
    int line = 0;
#pragma unroll
    for (int k = 0; k < PVD_MAX_LEVELS; ++k) {
      if (k == t) {
        off = lv.offset[k];
        s = lv.side[k];
      }
      if (k < t) line += 4 * lv.side[k];
    }
    const int by = __ldg(b + t * side_f + y), bz = __ldg(b + t * side_f + z);
    const float fy = __ldg(f + t * side_f + y), fz = __ldg(f + t * side_f + z);
    c_base[t] = off + (long long)by * s + (long long)bz * s * s;
    c_side[t] = (int)s;
    c_line[t] = line;
    c_w[t][0] = __fsub_rn(1.f, fy);
    c_w[t][1] = fy;
    c_w[t][2] = __fsub_rn(1.f, fz);
    c_w[t][3] = fz;
  }
  __syncthreads();
  for (int x = t; x < side_f; x += THREADS)  // the finest level
    row[x * ld + ld - 1] = __ldg(table + c_base[ld - 1] + x);
  for (int j = 0; j < ld - 1; ++j) {  // coarse level j's 4 lines
    const int s = c_side[j];
    const long long s2 = (long long)s * s;
    for (int e = t; e < 4 * s; e += THREADS) {
      const int l = e / s, i = e - l * s;
      lines[c_line[j] + e] =
          __ldg(table + c_base[j] + (l & 1) * s + (l >> 1) * s2 + i);
    }
  }
  __syncthreads();
  const int n = side_f * (ld - 1);
  for (int e = t; e < n; e += THREADS) {
    const int j = e / side_f, x = e - j * side_f;
    const int s = c_side[j], bx = __ldg(b + e);
    const float fx = __ldg(f + e);
    const float wx[2] = {__fsub_rn(1.f, fx), fx};
    const float2* ln = lines + c_line[j] + bx;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = __fmul_rn(__fmul_rn(wx[k & 1], c_w[j][(k >> 1) & 1]),
                                c_w[j][2 + ((k >> 2) & 1)]);
      const float2 c = ln[(k & 1) + (k >> 1) * s];
      a0 = __fadd_rn(a0, __fmul_rn(c.x, w));
      a1 = __fadd_rn(a1, __fmul_rn(c.y, w));
    }
    row[x * ld + j] = make_float2(a0, a1);
  }
  __syncthreads();
  float2* dst = baked + ((long long)z * side_f + y) * side_f * ld;
  for (int e = t; e < side_f * ld; e += THREADS) dst[e] = row[e];
}

extern "C" int cand_k16(int variant, int threads, const float* table,
                        const int* b, const float* f, float* baked,
                        int side_f, HashLevels lv, void* stream) {
  const int ld = lv.n_levels;
  if (ld == 0 || side_f <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* t2 = reinterpret_cast<const float2*>(table);
  float2* o2 = reinterpret_cast<float2*>(baked);
  const size_t smem = (size_t)side_f * ld * sizeof(float2);
  switch (variant) {
    case 0: {
      const long long n = (long long)side_f * side_f * side_f * ld;
      k16_first_design_kernel<<<(unsigned)((n + threads - 1) / threads),
                                threads, 0, st>>>(t2, b, f, o2, side_f, lv);
      break;
    }
    case 1: {
      k16_grid3_kernel<<<dim3((side_f + threads - 1) / threads, side_f,
                              side_f),
                         dim3(ld, threads), 0, st>>>(t2, b, f, o2, side_f,
                                                     lv);
      break;
    }
    case 2:
    case 3:
    case 4:
    case 5: {
      const dim3 grid(side_f, side_f);
      size_t sm = smem;
      if (variant == 5) {  // (c): room for the lines
        int lines = 0;
        for (int j = 0; j + 1 < ld; ++j) lines += 4 * lv.side[j];
        sm += (size_t)lines * sizeof(float2);
      }
#define CAND_K16_A(TH)                                                     \
  if (threads == TH) {                                                     \
    if (variant == 2)                                                      \
      hash_bake_kernel<TH><<<grid, TH, sm, st>>>(t2, b, f, o2, side_f, lv); \
    else if (variant == 3)                                                 \
      k16_entries_kernel<TH, 2><<<grid, TH, sm, st>>>(t2, b, f, o2,        \
                                                      side_f, lv);         \
    else if (variant == 4)                                                 \
      k16_entries_kernel<TH, 3><<<grid, TH, sm, st>>>(t2, b, f, o2,        \
                                                      side_f, lv);         \
    else                                                                   \
      k16_lines_kernel<TH><<<grid, TH, sm, st>>>(t2, b, f, o2, side_f, lv); \
    break;                                                                 \
  }
      CAND_K16_A(64) CAND_K16_A(128) CAND_K16_A(256)
#undef CAND_K16_A
      return (int)cudaErrorInvalidValue;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
