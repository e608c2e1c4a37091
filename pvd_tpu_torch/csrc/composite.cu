// K3: compositing of a compacted sample stream, forward; K6: its backward;
// K8, K9: the padded composite, forward and backward (below).
//
// K3 replaces pvd_tpu/ops/composite.py:28 composite_rays_compact.  The TPU
// version takes the segmented exclusive transmittance with a log-depth
// associative_scan over (value, reset) pairs and sums per ray with one
// scatter-add; on the GPU each ray's slots are one contiguous range.
//
//   alpha_i  = 1 - exp(-sigma_i * dt_i)
//   T_i      = prod_{j < i in the ray} (1 - alpha_j)
//   weight_i = alpha_i * T_i, alpha zeroed where T_i < 1e-4 if early_stop
//              (T keeps using the unmodified alphas, composite.py:69-73)
//   per ray: weights_sum = sum w, depth = sum w * t_cum, image = sum w * rgb
//
// The stream is what compact_samples produces: valid slots form a prefix,
// each ray's valid slots are contiguous, and invalid slots may carry any ray
// id (eval's tail carries ray 0, so ray_id is not monotone there).  Pass 1
// (one thread per slot) finds each ray's [start, end) from the valid slots
// only and zeroes the weights of invalid slots; K6 reads those bounds too.
// A ray with no valid slot gets an empty range from pass 2 (so the bounds
// need no zero fill, a launch of its own) and writes zeros.  No atomics:
// every output has one writer.
//
// Bound on the H100: memory, and at these sizes launch latency.  A 4096-ray
// serving chunk at budget 65,536 reads 37 B per slot and writes 4 B per
// slot plus 20 B per ray (2.5 MB, under a microsecond at 3.35 TB/s).  The
// first design's pass 2 ran one thread per ray: 4096 threads, less than one
// warp per SM, each walking a serial chain of loads strided across rays
// (16 slots long at the serving ladder's 1x rung, 256 at 16x), 72x its
// bound.  Pass 2 now gives each ray a group of G lanes (16 or 32, the host's
// pick from the mean budget per ray, ops/composite.py k3_lanes) that walks
// the ray in tiles of G slots with coalesced loads of sigma, dt and t_cum
// and of the tile's 3 G floats of rgb, the next tile's loads in flight
// while it works on this one (the 1x rung's truncated chunks give a few
// hundred rays ~100 slots each).  In each tile every lane takes the
// tile's factors 1 - alpha_k from its group by broadcast shuffles and
// multiplies them in slot order, keeping the product before its own slot:
// T is the first design's serial product bit for bit, so the weights are
// too, and the group carries the tile's product to the next tile.  A tile
// that begins with T < 1e-4 under early stop ends the walk: the rest of
// the ray's weights are written as zeros without loading it.  The per-ray
// sums are reduced across the group by shuffles (another order than the
// serial one) and one lane writes them.

// K6 (backward, replaces the autodiff of the associative scan in
// composite_rays_compact; closed form as in the reference's
// raymarching.cu:606-697).  With the upstream gradients of the per-ray sums
// and of the weights, per slot G_i = g_img . rgb_i + g_ws + g_depth * t_cum_i
// + g_w_i, S = sum_j w_j G_j over the ray, and T_{i+1} = T_i (1 - alpha_i):
//   dsigma_i = dt_i * (T_{i+1} G_i - (S - sum_{j<=i} w_j G_j))
//   drgb_i   = w_i * g_img
// It reuses K3's bounds and the saved weights.  No gradient to dt, t_cum or
// positions.  Bound: memory (37 B read and 16 B written per slot).  The
// first design ran one thread per ray in blocks of 64, walking its range
// twice (S, then the running prefix) with loads strided across the warp's
// rays: a serial chain of L2 round trips, as K3's first design was, and at
// the A/B recipe's 4096 rays 64 blocks on 132 SMs; its wrapper zero-filled
// both outputs first (two more launches).  On the H100 that was 0.012-0.019
// ms of kernel and 0.007 of fills, 15-54x the bound (PERF.md §6).
// The design now (composite_bwd_kernel): K3's pass-2 groups, G = 16 or 32
// lanes a ray (k3_lanes) walking it in tiles of G slots with coalesced
// loads; the first K6_CACHED tiles' inputs stay in registers for the
// second walk (the training paths cap a ray at 96 or 64 slots: 4-6 tiles
// of 16); S by a group reduction; T by K3's broadcast product in slot
// order (T_i bit for bit the forward's); sum_{j<=i} w_j G_j by a group
// scan with a carry across tiles; d_sigma and the tile's 3 G floats of
// d_rgb stored by consecutive lanes.  The blocks after the rays' write the
// zeros of the slots no ray owns (invalid, or a ray id out of range, as
// pass 1 drops them), so the wrapper allocates the outputs without a fill.
// Only the order of the sums differs from the first design.

// K8 (forward) and K9 (backward): the padded composite, replacing
// pvd_tpu/ops/composite.py:97 composite_rays and its autodiff (a cumprod and
// cumsums over [N, S] blocks).  The teacher trainer runs its first
// 16 x update_extra_interval steps on this path (the sample budget is off
// while the occupancy grid warms up), and eval with samples_per_ray = 0.
//   alpha_i = (1 - exp(-sigma_i * dt_i)) * m_i
//   T_i     = prod_{j<i} (1 - alpha_j)      (exclusive, from the unmodified
//                                            alphas)
//   w_i     = alpha_i * T_i, alpha zeroed where T_i < 1e-4 if early_stop
//   t_cum_i = sum_{j<=i} delta_depth_j * m_j
// K8 writes weights [N, S] and weights_sum, depth = sum w * t_cum,
// image = sum w * rgb.  Bound on the H100: memory, the mask (1 B a slot),
// the valid slots' sigma, dt, delta_depth and rgb (24 B) read once, the
// weights (4 B a slot) and 20 B a ray written once: 1.8 us at the exact
// teacher's [8192, 96] (~79,000 valid slots).  The first design ran one
// thread per ray in blocks of 64 (128 blocks at 8,192 rays), walking its
// S slots in turn with every slot's inputs loaded, masked or not, at a
// stride of S floats from its neighbour's: 0.029-0.030 ms alone at
// [8192, 96] and [4096, 96], 0.022-0.024 at [4096, 64], 16x its bound.
// The design now (composite_padded_fwd_kernel): K9's lane groups over a
// forward walk, a warp a ray (K8_LANES) in tiles of 32 slots, the masks of
// K8_ROW / 32 = 3 tiles loaded together, then only the valid slots'
// inputs; a tile without a valid slot writes its weights and leaves T and
// t_cum; T by the broadcast product (the weights are the first design's
// bit for bit, which K9 relies on), t_cum by a group scan, the sums by
// group reductions (only their order differs).  On the H100 80GB HBM3 at
// 700 W (PERF.md §6, the kernel alone) 0.0065-0.0069 ms at [8192, 96],
// 0.0043 at [4096, 96], 0.0047-0.0048 at [4096, 64], 3.6-4.7x its bound:
// the time is as long with early stop and on prefixes of 0-20 slots
// (0.0065-0.0067 at 8,192 rays), so the long rows do not set it; the
// per-warp walk of 8,192 warps (56 registers: ~1.9 waves) does.  Measured
// and dropped, in rotated rounds at the trained batches' synthetic shapes
// (tools/torch_k8_k16_rounds.py; the shipped 0.00660 / 0.00467 / 0.00484
// ms at [8192, 96] / [4096, 96] / [4096, 64], 0.00650 on prefixes of
// 0-20 slots): a tile's loads at a time, 0.00722 / 0.00506 / 0.00462 /
// 0.00684; 2 tiles' loads together, 0.00728 / 0.00521 / 0.00450 /
// 0.00684 (both faster only at [4096, 64], by 5-7%); 16 lanes a ray, 96
// slots' loads together, 0.00798 / 0.00565 / 0.00495 / 0.00706, a tile at
// a time 0.00962 / 0.00704 / 0.00534 / 0.00756; and (rounds since taken
// out of the tool) the shipped body held to 16 or 10 blocks an SM (32
// registers, spilling: 0.0150-0.0152 at [8192, 96]; 51: 0.0072).
// K9 is K6's closed form over a padded row, with G_i = g_img . rgb_i + g_ws
// + g_depth * t_cum_i + g_w_i and S = sum w_j G_j:
//   dsigma_i = m_i * dt_i * (T_{i+1} G_i - (S - sum_{j<=i} w_j G_j))
//   drgb_i   = w_i * g_img                  (0 where m_i is 0)
// (no early stop: inference only).  Every output has one writer, no
// atomics.  Bound on the H100: memory.  A training row holds a ray's few
// samples among S = 96 or 64 slots (10-11% valid at the exact and A/B
// teachers' warm-up, ~45-50% at the large scene's), so K9 need only read
// the mask, the valid slots' inputs (32 B each) and the per-ray values,
// and write both outputs (16 B a slot): 4.8 us at the exact teacher's
// [8192, 96].  The first design ran one thread per ray in blocks of 64
// (128 blocks for 132 SMs at 8192 rays, 64 at 4096), walking its row twice
// with every slot's inputs loaded, masked or not, at a stride of S floats
// from its neighbour's: a serial chain of L2 round trips, 18-33x its bound
// (PERF.md §6).  The design now (composite_padded_bwd_kernel): K6's lane
// groups, a warp a ray (K9_LANES) walking the row in tiles of 32 slots.  A lane reads
// its slot's mask first and the other inputs only where it is set; a tile
// without a valid slot (most of a padded row) writes zeros and leaves T,
// t_cum and the prefix as they were.  t_cum by a group scan with a carry,
// S by a group reduction, the row's first 96 slots kept in registers
// between the two walks, T by K3's broadcast product (bit for bit K8's),
// sum_{j<=i} w_j G_j by a group scan, d_sigma and the tile's 3 G floats
// of d_rgb stored by consecutive lanes (group_transmittance, group_scan,
// group_sum and group_store_drgb, shared with K3 and K6).  Only the order
// of the sums (t_cum's too) differs from the first design.  On the H100
// 80GB HBM3 at 700 W (PERF.md §6) the kernel alone takes 0.0077-0.0078
// ms at [8192, 96] against the first design's 0.085-0.087, and
// 0.0050-0.0057 against 0.056-0.081 at the 4096-ray batches: 1.6-2.3x
// its bound.  The long rows set its time: in the exact teacher's warm-up
// ~1,080 of 8,192 rows hold every valid slot, 73 each on average, and a
// warp walks its row's tiles in turn (the same batch with prefixes of
// 0-20 slots takes 0.0062-0.0070).  Measured and dropped: 16 lanes a
// ray, slower on every trained batch (0.0104-0.0112 at [8192, 96]).

#include <cuda_runtime.h>
#include <stdint.h>

#define K3_THREADS 128
#define K6_THREADS 128
#define K6_CACHED 4  // tiles a K6 group keeps in registers between its walks
#define K8_THREADS 128
#define K8_LANES 32  // a warp a ray
#define K8_ROW 96  // slots of a row whose loads a K8 group issues together
#define K9_THREADS 128
#define K9_LANES 32  // a warp a ray
#define K9_ROW 96  // slots of a row a K9 warp keeps in registers

// The lane groups of K3, K6 and K9: a group of G lanes (G | 32; `group` its
// lanes' mask, j a lane's index in it) walks a ray in tiles of G slots.

// T by the broadcast product in slot order: lane j gets T times the tile's
// factors f_0 ... f_{j-1}, rounded as a serial walk rounds them, and T
// becomes the product over the whole tile in every lane.
template <int G>
__device__ __forceinline__ float group_transmittance(unsigned group, int j,
                                                     float f, float& T) {
  float Tj = T;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float fk = __shfl_sync(group, f, k, G);
    if (k == j) Tj = T;
    T = __fmul_rn(T, fk);
  }
  return Tj;
}

// Inclusive scan of v over the group plus carry; carry becomes the scan's
// last value (the carry into the next tile).
template <int G>
__device__ __forceinline__ float group_scan(unsigned group, int j, float v,
                                            float& carry) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float y = __shfl_up_sync(group, v, o, G);
    if (j >= o) v += y;
  }
  v += carry;
  carry = __shfl_sync(group, v, G - 1, G);
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(unsigned group, float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(group, v, o, G);
  return v;
}

// d_rgb of a tile of n slots: float j + m G of its 3 n, slot (j + m G) / 3,
// is that slot's w times g_img's channel (j + m G) % 3, stored by
// consecutive lanes at dst (the tile's first d_rgb float).
template <int G>
__device__ __forceinline__ void group_store_drgb(unsigned group, int j,
                                                 float w, int n, float gi0,
                                                 float gi1, float gi2,
                                                 float* __restrict__ dst) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int qi = j + m * G;
    const float wq = __shfl_sync(group, w, qi / 3, G);
    if (qi < 3 * n) {
      const int ch = qi % 3;
      dst[qi] = wq * (ch == 0 ? gi0 : (ch == 1 ? gi1 : gi2));
    }
  }
}

// G_i = g_img . rgb_i + g_ws + g_depth * t_cum_i + g_w_i of one slot (K6,
// K9), in the first designs' expression
__device__ __forceinline__ float composite_term(float r0, float r1, float r2,
                                                float tc, float gw, float gi0,
                                                float gi1, float gi2,
                                                float gws, float gd) {
  return gi0 * r0 + gi1 * r1 + gi2 * r2 + gws + gd * tc + gw;
}

__global__ void segment_bounds_kernel(const long long* __restrict__ ray_id,
                                      const uint8_t* __restrict__ valid,
                                      int n_samples, int n_rays,
                                      int* __restrict__ start,
                                      int* __restrict__ end,
                                      float* __restrict__ weights) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_samples) return;
  const long long r = ray_id[i];
  if (!valid[i] || r < 0 || r >= n_rays) {
    weights[i] = 0.f;
    return;
  }
  if (i == 0 || !valid[i - 1] || ray_id[i - 1] != r) start[r] = i;
  if (i == n_samples - 1 || !valid[i + 1] || ray_id[i + 1] != r)
    end[r] = i + 1;
}

// K3 pass 2: a group of G lanes per ray, G | 32.  Every lane of a group
// runs the same shuffles, so T is the same in each.  Pass 1 wrote the
// bounds of every ray with a valid slot; a ray without one finds whatever
// the buffer held, so the group checks that start[r] begins a run of ray r
// and writes an empty range back otherwise (K6 reads the bounds).
template <int G>
__global__ void __launch_bounds__(K3_THREADS)
    composite_kernel(const float* __restrict__ sigmas,
                     const float* __restrict__ rgbs,
                     const float* __restrict__ dts,
                     const float* __restrict__ t_cum,
                     const long long* __restrict__ ray_id,
                     const uint8_t* __restrict__ valid, int n_samples,
                     int* __restrict__ start, int* __restrict__ end,
                     int n_rays, int early_stop, float* __restrict__ weights,
                     float* __restrict__ ws_out,
                     float* __restrict__ depth_out,
                     float* __restrict__ image_out) {
  const int r = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (r >= n_rays) return;  // the whole group
  const int j = threadIdx.x & (G - 1);
  const unsigned group = (unsigned)((1ull << G) - 1ull)
                         << ((threadIdx.x & 31) & ~(G - 1));
  int s = start[r], e = end[r];
  if (!(s >= 0 && s < n_samples && valid[s] && ray_id[s] == r &&
        (s == 0 || !valid[s - 1] || ray_id[s - 1] != r))) {
    s = e = 0;
    if (j == 0) start[r] = end[r] = 0;
  }
  // a tile's loads: sigma, dt and t_cum of slot i0 + j, and float j + m G
  // of the tile's rgb (slot (j + m G) / 3, channel (j + m G) % 3); the
  // next tile's are in flight while the group works on this one
  float sg = 0.f, dt = 0.f, tc = 0.f, rgb[3] = {0.f, 0.f, 0.f};
  auto load = [&](int i0) {
    const int i = i0 + j, nq = 3 * min(G, e - i0);
    if (i < e) {
      sg = sigmas[i];
      dt = dts[i];
      tc = t_cum[i];
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (j + m * G < nq) rgb[m] = rgbs[3 * (long long)i0 + j + m * G];
  };
  int i0 = s;
  if (i0 < e) load(i0);
  float T = 1.f, ws = 0.f, depth = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (; i0 < e; i0 += G) {
    if (early_stop && T < 1e-4f) break;  // T only falls from here on
    const int i = i0 + j;
    const bool in = i < e;
    const int nq = 3 * min(G, e - i0);
    const float sg_i = sg, dt_i = dt, tc_i = tc;
    const float q[3] = {rgb[0], rgb[1], rgb[2]};
    if (i0 + G < e) load(i0 + G);
    const float alpha =
        in ? __fsub_rn(1.f, expf(__fmul_rn(-sg_i, dt_i))) : 0.f;
    const float Tj = group_transmittance<G>(group, j, __fsub_rn(1.f, alpha),
                                            T);
    float w = 0.f;
    if (in) {
      w = (early_stop && Tj < 1e-4f) ? 0.f : __fmul_rn(alpha, Tj);
      weights[i] = w;
      ws = __fadd_rn(ws, w);
      depth = __fmaf_rn(w, tc_i, depth);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int qi = j + m * G;
      const float wq = __shfl_sync(group, w, qi / 3, G);
      if (qi < nq) {
        const int ch = qi % 3;
        if (ch == 0) c0 = __fmaf_rn(wq, q[m], c0);
        else if (ch == 1) c1 = __fmaf_rn(wq, q[m], c1);
        else c2 = __fmaf_rn(wq, q[m], c2);
      }
    }
  }
  for (int i = i0 + j; i < e; i += G) weights[i] = 0.f;  // after an early stop
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    ws += __shfl_xor_sync(group, ws, o, G);
    depth += __shfl_xor_sync(group, depth, o, G);
    c0 += __shfl_xor_sync(group, c0, o, G);
    c1 += __shfl_xor_sync(group, c1, o, G);
    c2 += __shfl_xor_sync(group, c2, o, G);
  }
  if (j) return;
  ws_out[r] = ws;
  depth_out[r] = depth;
  image_out[3 * r] = c0;
  image_out[3 * r + 1] = c1;
  image_out[3 * r + 2] = c2;
}

// lanes per ray: 16 or 32 (ops/composite.py k3_lanes); the bounds need no
// initial value
extern "C" int pvd_composite_compact_fwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* t_cum, const long long* ray_id, const uint8_t* valid,
    int n_samples, int n_rays, int early_stop, int lanes, int* bounds,
    float* weights, float* weights_sum, float* depth, float* image,
    void* stream) {
  if (lanes != 16 && lanes != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (n_samples > 0) {
    segment_bounds_kernel<<<(n_samples + threads - 1) / threads, threads, 0,
                            st>>>(ray_id, valid, n_samples, n_rays, bounds,
                                  bounds + n_rays, weights);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (n_rays > 0) {
    const long long blocks =
        ((long long)n_rays * lanes + K3_THREADS - 1) / K3_THREADS;
    if (lanes == 16)
      composite_kernel<16><<<(unsigned)blocks, K3_THREADS, 0, st>>>(
          sigmas, rgbs, dt, t_cum, ray_id, valid, n_samples, bounds,
          bounds + n_rays, n_rays, early_stop, weights, weights_sum, depth,
          image);
    else
      composite_kernel<32><<<(unsigned)blocks, K3_THREADS, 0, st>>>(
          sigmas, rgbs, dt, t_cum, ray_id, valid, n_samples, bounds,
          bounds + n_rays, n_rays, early_stop, weights, weights_sum, depth,
          image);
  }
  return (int)cudaGetLastError();
}

// K6's G_i = g_img . rgb_i + g_ws + g_depth * t_cum_i + g_w_i of slot i
__device__ __forceinline__ float k6_term(const float* __restrict__ rgbs,
                                         const float* __restrict__ t_cum,
                                         const float* __restrict__ g_weights,
                                         int i, float gi0, float gi1,
                                         float gi2, float gws, float gd) {
  return composite_term(rgbs[3 * (long long)i], rgbs[3 * (long long)i + 1],
                        rgbs[3 * (long long)i + 2], t_cum[i], g_weights[i],
                        gi0, gi1, gi2, gws, gd);
}

// K6: blocks below ray_blocks give each ray a group of G lanes (G | 32, as
// K3's pass 2); the blocks after them take one slot a thread and write the
// zeros of the slots no ray owns (invalid, or a ray id out of range, as
// pass 1 drops them).  A group walks its ray twice in tiles of G slots:
// first S = sum w_j G_j (lane partial sums, then a group reduction),
// keeping its first K6_CACHED tiles' sigma, dt, w and G in registers; then
// each tile's T by K3's broadcast product in slot order (T_i bit for bit
// the forward's), sum_{j<=i} w_j G_j by a group scan with a carry across
// tiles, d_sigma at slot i and the tile's 3 G floats of d_rgb by
// consecutive lanes.
template <int G>
__global__ void __launch_bounds__(K6_THREADS) composite_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ t_cum,
    const float* __restrict__ weights, const int* __restrict__ start,
    const int* __restrict__ end, const long long* __restrict__ ray_id,
    const uint8_t* __restrict__ valid, int n_samples, int n_rays,
    int ray_blocks, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, float* __restrict__ d_sigma,
    float* __restrict__ d_rgb) {
  if ((int)blockIdx.x >= ray_blocks) {
    const long long i =
        (long long)(blockIdx.x - ray_blocks) * blockDim.x + threadIdx.x;
    if (i >= n_samples) return;
    const long long r = valid[i] ? ray_id[i] : -1;
    if (r >= 0 && r < n_rays) return;
    d_sigma[i] = 0.f;
    d_rgb[3 * i] = d_rgb[3 * i + 1] = d_rgb[3 * i + 2] = 0.f;
    return;
  }
  const int r = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (r >= n_rays) return;  // the whole group
  const int j = threadIdx.x & (G - 1);
  const unsigned group = (unsigned)((1ull << G) - 1ull)
                         << ((threadIdx.x & 31) & ~(G - 1));
  const int s = start[r], e = end[r];
  const float gi0 = g_image[3 * r], gi1 = g_image[3 * r + 1],
              gi2 = g_image[3 * r + 2], gws = g_ws[r], gd = g_depth[r];
  // walk 1: S; the first tiles' inputs stay in registers
  float c_sg[K6_CACHED], c_dt[K6_CACHED], c_w[K6_CACHED], c_g[K6_CACHED];
  float S = 0.f;
#pragma unroll
  for (int t = 0; t < K6_CACHED; ++t) {
    const int i = s + t * G + j;
    c_sg[t] = c_dt[t] = c_w[t] = c_g[t] = 0.f;
    if (i < e) {
      c_sg[t] = sigmas[i];
      c_dt[t] = dts[i];
      c_w[t] = weights[i];
      c_g[t] = k6_term(rgbs, t_cum, g_weights, i, gi0, gi1, gi2, gws, gd);
    }
    S = fmaf(c_w[t], c_g[t], S);
  }
  for (int i = s + K6_CACHED * G + j; i < e; i += G)
    S = fmaf(weights[i],
             k6_term(rgbs, t_cum, g_weights, i, gi0, gi1, gi2, gws, gd), S);
  S = group_sum<G>(group, S);
  // walk 2
  float T = 1.f, carry = 0.f;
  auto tile = [&](int i0, float sg, float dt, float w, float gv) {
    const int i = i0 + j;
    const bool in = i < e;
    const float alpha = in ? __fsub_rn(1.f, expf(__fmul_rn(-sg, dt))) : 0.f;
    const float f = __fsub_rn(1.f, alpha);
    const float Tj = group_transmittance<G>(group, j, f, T);
    // sum_{j<=i} w_j G_j
    const float pre = group_scan<G>(group, j, in ? w * gv : 0.f, carry);
    if (in) d_sigma[i] = dt * (__fmul_rn(Tj, f) * gv - (S - pre));
    group_store_drgb<G>(group, j, w, min(G, e - i0), gi0, gi1, gi2,
                        d_rgb + 3 * (long long)i0);
  };
#pragma unroll
  for (int t = 0; t < K6_CACHED; ++t) {
    if (s + t * G >= e) break;
    tile(s + t * G, c_sg[t], c_dt[t], c_w[t], c_g[t]);
  }
  for (int i0 = s + K6_CACHED * G; i0 < e; i0 += G) {
    const int i = i0 + j;
    float sg = 0.f, dt = 0.f, w = 0.f, gv = 0.f;
    if (i < e) {
      sg = sigmas[i];
      dt = dts[i];
      w = weights[i];
      gv = k6_term(rgbs, t_cum, g_weights, i, gi0, gi1, gi2, gws, gd);
    }
    tile(i0, sg, dt, w, gv);
  }
}

// lanes per ray: 16 or 32 (ops/composite.py k3_lanes); the bounds from the
// forward; d_sigma and d_rgb need no initial value
extern "C" int pvd_composite_compact_bwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* t_cum, const float* weights, const int* bounds,
    const long long* ray_id, const uint8_t* valid, int n_samples,
    int n_rays, int lanes, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_weights, float* d_sigma,
    float* d_rgb, void* stream) {
  if (lanes != 16 && lanes != 32) return (int)cudaErrorInvalidValue;
  const int ray_blocks =
      (int)(((long long)n_rays * lanes + K6_THREADS - 1) / K6_THREADS);
  const int blocks = ray_blocks + (n_samples + K6_THREADS - 1) / K6_THREADS;
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 16)
    composite_bwd_kernel<16><<<blocks, K6_THREADS, 0, st>>>(
        sigmas, rgbs, dt, t_cum, weights, bounds, bounds + n_rays, ray_id,
        valid, n_samples, n_rays, ray_blocks, g_ws, g_depth, g_image,
        g_weights, d_sigma, d_rgb);
  else
    composite_bwd_kernel<32><<<blocks, K6_THREADS, 0, st>>>(
        sigmas, rgbs, dt, t_cum, weights, bounds, bounds + n_rays, ray_id,
        valid, n_samples, n_rays, ray_blocks, g_ws, g_depth, g_image,
        g_weights, d_sigma, d_rgb);
  return (int)cudaGetLastError();
}

// K8: a group of G = K8_LANES lanes per ray (a warp; G | 32) walks its
// row of S slots in tiles of G, C = K8_ROW / G tiles at a time: it loads
// the C tiles' masks together, then, for the tiles' valid slots only,
// sigma, dt, delta_depth and the tile's 3 G floats of rgb (float j + m G
// of the tile, slot (j + m G) / 3, loaded where that slot's mask bit is
// set), all in flight together, and works through the tiles in order.  A
// tile with no valid slot writes its weights as 0 * T (0, or NaN after a
// NaN alpha, as the first design's serial walk writes them) and leaves T
// and t_cum as they were: a masked slot's factor is 1 and its delta_depth
// counts 0.  A live tile takes T by the broadcast product in slot order
// (the first design's serial product, so w = alpha * T_j bit for bit), and
// t_cum by a group scan of m * delta_depth with a carry.  Under early stop
// a slot whose T_j < 1e-4 gets w = 0, and a tile that begins with
// T < 1e-4 ends the walk: the rest of the row's weights are written as
// zeros (T only falls from there; a chunk's loads are issued before its
// tiles test T).  Weights are stored by consecutive lanes; ws, depth and
// the image are lane partial sums reduced across the group, written by
// lane 0.
template <int G, int C>
__global__ void __launch_bounds__(K8_THREADS) composite_padded_fwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ dds,
    const uint8_t* __restrict__ mask, int n_rays, int S, int early_stop,
    float* __restrict__ weights, float* __restrict__ ws_out,
    float* __restrict__ depth_out, float* __restrict__ image_out) {
  const int r = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (r >= n_rays) return;  // the whole group
  const int j = threadIdx.x & (G - 1);
  const int first = (threadIdx.x & 31) & ~(G - 1);  // the group's lane 0
  const unsigned group = (unsigned)((1ull << G) - 1ull) << first;
  const long long base = (long long)r * S;
  float* __restrict__ wrow = weights + base;
  float T = 1.f, tc_carry = 0.f, ws = 0.f, depth = 0.f, c0 = 0.f, c1 = 0.f,
        c2 = 0.f;
  int z = S;  // the row's first slot left to zero after an early stop
  for (int i0 = 0; i0 < S && z == S; i0 += C * G) {
    if (early_stop && T < 1e-4f) {
      z = i0;
      break;
    }
    unsigned live[C];  // the tiles' valid slots, bit k for slot k
    float sg[C], dt[C], dd[C], q[C][3];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = i0 + t * G + j;
      live[t] = (__ballot_sync(group, i < S && mask[base + i] != 0) & group)
                >> first;
    }
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const long long i = base + i0 + t * G + j;
      sg[t] = dt[t] = dd[t] = 0.f;
      if ((live[t] >> j) & 1u) {
        sg[t] = sigmas[i];
        dt[t] = dts[i];
        dd[t] = dds[i];
      }
      const float* tile = rgbs + 3 * (base + i0 + t * G);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int qi = j + m * G;
        q[t][m] = ((live[t] >> (qi / 3)) & 1u) ? tile[qi] : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int t0 = i0 + t * G;
      if (t0 >= S) break;  // the whole group
      if (early_stop && T < 1e-4f) {
        z = t0;
        break;
      }
      const bool in = j < S - t0;
      if (!live[t]) {  // the whole group
        if (in) wrow[t0 + j] = __fmul_rn(0.f, T);
        continue;
      }
      const bool m = (live[t] >> j) & 1u;
      const float alpha =
          m ? __fsub_rn(1.f, expf(__fmul_rn(-sg[t], dt[t]))) : 0.f;
      const float Tj = group_transmittance<G>(group, j, __fsub_rn(1.f, alpha),
                                              T);
      const float w = (early_stop && Tj < 1e-4f) ? 0.f : __fmul_rn(alpha, Tj);
      const float tc = group_scan<G>(group, j, m ? dd[t] : 0.f, tc_carry);
      if (in) wrow[t0 + j] = w;
      ws = __fadd_rn(ws, w);
      depth = __fmaf_rn(w, tc, depth);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int qi = j + k * G;
        const float wq = __shfl_sync(group, w, qi / 3, G);
        const int ch = qi % 3;
        if (ch == 0) c0 = __fmaf_rn(wq, q[t][k], c0);
        else if (ch == 1) c1 = __fmaf_rn(wq, q[t][k], c1);
        else c2 = __fmaf_rn(wq, q[t][k], c2);
      }
    }
  }
  for (int i = z + j; i < S; i += G) wrow[i] = 0.f;
  ws = group_sum<G>(group, ws);
  depth = group_sum<G>(group, depth);
  c0 = group_sum<G>(group, c0);
  c1 = group_sum<G>(group, c1);
  c2 = group_sum<G>(group, c2);
  if (j) return;
  ws_out[r] = ws;
  depth_out[r] = depth;
  image_out[3 * r] = c0;
  image_out[3 * r + 1] = c1;
  image_out[3 * r + 2] = c2;
}

extern "C" int pvd_composite_padded_fwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* delta_depth, const uint8_t* mask, int n_rays, int S,
    int early_stop, float* weights, float* weights_sum, float* depth,
    float* image, void* stream) {
  if (n_rays <= 0) return 0;
  const long long blocks =
      ((long long)n_rays * K8_LANES + K8_THREADS - 1) / K8_THREADS;
  composite_padded_fwd_kernel<K8_LANES, K8_ROW / K8_LANES>
      <<<(unsigned)blocks, K8_THREADS, 0, (cudaStream_t)stream>>>(
          sigmas, rgbs, dt, delta_depth, mask, n_rays, S, early_stop,
          weights, weights_sum, depth, image);
  return (int)cudaGetLastError();
}

// K9: a group of G = K9_LANES lanes per ray (a warp; 16 lanes measured
// slower at every launch shape, PERF.md §6) walks its row of S slots in
// tiles of G.  A lane reads its slot's mask
// first and the slot's other inputs only where it is set; a tile with no
// valid slot (most of a padded row: the march fills a ray's first slots)
// only writes zeros, and leaves T, t_cum and the prefix as they were.
// Walk 1: t_cum by a group scan of m * delta_depth with a carry, G_i, and
// S = sum w_j G_j (lane partial sums, then a group reduction), the first
// K9_ROW / G tiles' sigma, dt, w, G and mask kept in registers (a training
// row has at most 96 slots; a longer row's later tiles are loaded again).
// Walk 2: T by the broadcast product (bit for bit K8's serial product),
// sum_{j<=i} w_j G_j by a group scan with a carry, d_sigma and the tile's
// 3 G floats of d_rgb by consecutive lanes.  A masked slot's d_sigma and
// d_rgb are 0; every slot is written, so the outputs need no fill.
template <int G>
__global__ void __launch_bounds__(K9_THREADS) composite_padded_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ dds,
    const uint8_t* __restrict__ mask, const float* __restrict__ weights,
    int n_rays, int S, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, float* __restrict__ d_sigma,
    float* __restrict__ d_rgb) {
  constexpr int C = K9_ROW / G;
  const int r = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (r >= n_rays) return;  // the whole group
  const int j = threadIdx.x & (G - 1);
  const unsigned bit = 1u << (threadIdx.x & 31);
  const unsigned group = (unsigned)((1ull << G) - 1ull)
                         << ((threadIdx.x & 31) & ~(G - 1));
  const long long base = (long long)r * S;
  const float gi0 = g_image[3 * r], gi1 = g_image[3 * r + 1],
              gi2 = g_image[3 * r + 2], gws = g_ws[r], gd = g_depth[r];
  // a tile's inputs: `live` the group's valid lanes (0: nothing loaded)
  auto inputs = [&](int i0, float& tc_carry, unsigned& live, float& sg,
                    float& dt, float& w, float& gv) {
    const long long i = base + i0 + j;
    const bool m = i0 + j < S && mask[i] != 0;
    live = __ballot_sync(group, m);
    sg = dt = w = gv = 0.f;
    if (!live) return;  // the whole group
    const float tc = group_scan<G>(group, j, m ? dds[i] : 0.f, tc_carry);
    if (m) {
      sg = sigmas[i];
      dt = dts[i];
      w = weights[i];
      gv = composite_term(rgbs[3 * i], rgbs[3 * i + 1], rgbs[3 * i + 2], tc,
                          g_weights[i], gi0, gi1, gi2, gws, gd);
    }
  };
  // walk 1
  float c_sg[C], c_dt[C], c_w[C], c_g[C];
  unsigned c_live[C];
  float Ssum = 0.f, tc_carry = 0.f;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    c_live[t] = 0u;
    c_sg[t] = c_dt[t] = c_w[t] = c_g[t] = 0.f;
    if (t * G < S) {
      inputs(t * G, tc_carry, c_live[t], c_sg[t], c_dt[t], c_w[t], c_g[t]);
      Ssum = fmaf(c_w[t], c_g[t], Ssum);
    }
  }
  const float tc_row = tc_carry;  // t_cum after the cached tiles
  for (int i0 = C * G; i0 < S; i0 += G) {
    unsigned live;
    float sg, dt, w, gv;
    inputs(i0, tc_carry, live, sg, dt, w, gv);
    Ssum = fmaf(w, gv, Ssum);
  }
  Ssum = group_sum<G>(group, Ssum);
  // walk 2
  float T = 1.f, carry = 0.f;
  auto tile = [&](int i0, unsigned live, float sg, float dt, float w,
                  float gv) {
    const long long i = base + i0 + j;
    const int n = min(G, S - i0);
    float* dr = d_rgb + 3 * (base + i0);
    if (!live) {  // the whole group
      if (j < n) d_sigma[i] = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (j + m * G < 3 * n) dr[j + m * G] = 0.f;
      return;
    }
    const bool m = (live & bit) != 0;
    // the forward's alpha, rounded the same way
    const float alpha = m ? __fsub_rn(1.f, expf(__fmul_rn(-sg, dt))) : 0.f;
    const float f = __fsub_rn(1.f, alpha);
    const float Tj = group_transmittance<G>(group, j, f, T);
    const float pre = group_scan<G>(group, j, m ? w * gv : 0.f, carry);
    if (j < n) d_sigma[i] = m ? dt * (__fmul_rn(Tj, f) * gv - (Ssum - pre))
                              : 0.f;
    group_store_drgb<G>(group, j, w, n, gi0, gi1, gi2, dr);
  };
#pragma unroll
  for (int t = 0; t < C; ++t)
    if (t * G < S) tile(t * G, c_live[t], c_sg[t], c_dt[t], c_w[t], c_g[t]);
  tc_carry = tc_row;
  for (int i0 = C * G; i0 < S; i0 += G) {
    unsigned live;
    float sg, dt, w, gv;
    inputs(i0, tc_carry, live, sg, dt, w, gv);
    tile(i0, live, sg, dt, w, gv);
  }
}

// d_sigma and d_rgb need no initial value
extern "C" int pvd_composite_padded_bwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* delta_depth, const uint8_t* mask, const float* weights,
    int n_rays, int S, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_weights, float* d_sigma,
    float* d_rgb, void* stream) {
  if (n_rays <= 0 || S <= 0) return 0;
  const long long blocks =
      ((long long)n_rays * K9_LANES + K9_THREADS - 1) / K9_THREADS;
  composite_padded_bwd_kernel<K9_LANES>
      <<<(unsigned)blocks, K9_THREADS, 0, (cudaStream_t)stream>>>(
          sigmas, rgbs, dt, delta_depth, mask, weights, n_rays, S, g_ws,
          g_depth, g_image, g_weights, d_sigma, d_rgb);
  return (int)cudaGetLastError();
}
