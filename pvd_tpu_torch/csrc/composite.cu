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
// One thread per ray reuses K3's pass-1 bounds and the saved weights, with
// two passes over its range (S first, then the running prefix); invalid
// slots keep the zeros the wrapper allocates.  No gradient to dt, t_cum or
// positions.  Bound: memory (37 B read and 16 B written per slot); like
// K3's first design it is a serial chain of L2 loads per ray.

// K8 (forward) and K9 (backward): the padded composite, replacing
// pvd_tpu/ops/composite.py:97 composite_rays and its autodiff (a cumprod and
// cumsums over [N, S] blocks).  The teacher trainer runs its first
// 16 x update_extra_interval steps on this path (the sample budget is off
// while the occupancy grid warms up), and eval with samples_per_ray = 0.
// One thread per ray walks its S slots in order:
//   alpha_i = (1 - exp(-sigma_i * dt_i)) * m_i
//   T_i     = prod_{j<i} (1 - alpha_j)      (exclusive, from the unmodified
//                                            alphas)
//   w_i     = alpha_i * T_i, alpha zeroed where T_i < 1e-4 if early_stop
//   t_cum_i = sum_{j<=i} delta_depth_j * m_j
// and writes weights [N, S] and weights_sum, depth = sum w * t_cum,
// image = sum w * rgb.  K9 is K6's closed form over a padded row, with
// G_i = g_img . rgb_i + g_ws + g_depth * t_cum_i + g_w_i and S = sum w_j G_j:
//   dsigma_i = m_i * dt_i * (T_{i+1} G_i - (S - sum_{j<=i} w_j G_j))
//   drgb_i   = w_i * g_img
// (no early stop: inference only).  Every output has one writer, no
// atomics.  Bound on the H100: memory, a few MB at [8192, 96] (25 B read
// per slot forward, 29 B read and 16 B written backward); each thread's
// loads stride S floats from its neighbour's, so a warp touches 32 rows
// per step and relies on L1/L2 to reuse the lines over the next slots.

#include <cuda_runtime.h>
#include <stdint.h>

#define K3_THREADS 128

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
    const float f = __fsub_rn(1.f, alpha);
    float Tj = T;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float fk = __shfl_sync(group, f, k, G);
      if (k == j) Tj = T;
      T = __fmul_rn(T, fk);
    }
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

__global__ void composite_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ t_cum,
    const float* __restrict__ weights, const int* __restrict__ start,
    const int* __restrict__ end, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, int n_rays,
    float* __restrict__ d_sigma, float* __restrict__ d_rgb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int s = start[r], e = end[r];
  const float gi0 = g_image[3 * r], gi1 = g_image[3 * r + 1],
              gi2 = g_image[3 * r + 2], gws = g_ws[r], gd = g_depth[r];
  float S = 0.f;
  for (int i = s; i < e; ++i) {
    const float G = gi0 * rgbs[3 * i] + gi1 * rgbs[3 * i + 1] +
                    gi2 * rgbs[3 * i + 2] + gws + gd * t_cum[i] +
                    g_weights[i];
    S = fmaf(weights[i], G, S);
  }
  float T = 1.f, prefix = 0.f;
  for (int i = s; i < e; ++i) {
    const float w = weights[i];
    const float G = gi0 * rgbs[3 * i] + gi1 * rgbs[3 * i + 1] +
                    gi2 * rgbs[3 * i + 2] + gws + gd * t_cum[i] +
                    g_weights[i];
    prefix = fmaf(w, G, prefix);
    // the forward's alpha, rounded the same way
    const float alpha =
        __fsub_rn(1.f, expf(__fmul_rn(-sigmas[i], dts[i])));
    const float T_next = __fmul_rn(T, __fsub_rn(1.f, alpha));
    d_sigma[i] = dts[i] * (T_next * G - (S - prefix));
    d_rgb[3 * i] = w * gi0;
    d_rgb[3 * i + 1] = w * gi1;
    d_rgb[3 * i + 2] = w * gi2;
    T = T_next;
  }
}

extern "C" int pvd_composite_compact_bwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* t_cum, const float* weights, const int* bounds, int n_rays,
    const float* g_ws, const float* g_depth, const float* g_image,
    const float* g_weights, float* d_sigma, float* d_rgb, void* stream) {
  if (n_rays <= 0) return 0;
  const int ray_threads = 64;
  composite_bwd_kernel<<<(n_rays + ray_threads - 1) / ray_threads,
                         ray_threads, 0, (cudaStream_t)stream>>>(
      sigmas, rgbs, dt, t_cum, weights, bounds, bounds + n_rays, g_ws,
      g_depth, g_image, g_weights, n_rays, d_sigma, d_rgb);
  return (int)cudaGetLastError();
}

__global__ void composite_padded_fwd_kernel(
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

extern "C" int pvd_composite_padded_fwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* delta_depth, const uint8_t* mask, int n_rays, int S,
    int early_stop, float* weights, float* weights_sum, float* depth,
    float* image, void* stream) {
  if (n_rays <= 0) return 0;
  const int ray_threads = 64;
  composite_padded_fwd_kernel<<<(n_rays + ray_threads - 1) / ray_threads,
                                ray_threads, 0, (cudaStream_t)stream>>>(
      sigmas, rgbs, dt, delta_depth, mask, n_rays, S, early_stop, weights,
      weights_sum, depth, image);
  return (int)cudaGetLastError();
}

__global__ void composite_padded_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ dds,
    const uint8_t* __restrict__ mask, const float* __restrict__ weights,
    int n_rays, int S, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, float* __restrict__ d_sigma,
    float* __restrict__ d_rgb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long base = (long long)r * S;
  const float gi0 = g_image[3 * r], gi1 = g_image[3 * r + 1],
              gi2 = g_image[3 * r + 2], gws = g_ws[r], gd = g_depth[r];
  float Ssum = 0.f, t_cum = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = base + s;
    t_cum = __fadd_rn(t_cum, mask[i] ? dds[i] : 0.f);
    const float G = gi0 * rgbs[3 * i] + gi1 * rgbs[3 * i + 1] +
                    gi2 * rgbs[3 * i + 2] + gws + gd * t_cum + g_weights[i];
    Ssum = fmaf(weights[i], G, Ssum);
  }
  float T = 1.f, prefix = 0.f;
  t_cum = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = base + s;
    const bool m = mask[i] != 0;
    const float w = weights[i];
    t_cum = __fadd_rn(t_cum, m ? dds[i] : 0.f);
    const float G = gi0 * rgbs[3 * i] + gi1 * rgbs[3 * i + 1] +
                    gi2 * rgbs[3 * i + 2] + gws + gd * t_cum + g_weights[i];
    prefix = fmaf(w, G, prefix);
    // the forward's alpha, rounded the same way
    const float alpha =
        m ? __fsub_rn(1.f, expf(__fmul_rn(-sigmas[i], dts[i]))) : 0.f;
    const float T_next = __fmul_rn(T, __fsub_rn(1.f, alpha));
    d_sigma[i] = m ? dts[i] * (T_next * G - (Ssum - prefix)) : 0.f;
    d_rgb[3 * i] = w * gi0;
    d_rgb[3 * i + 1] = w * gi1;
    d_rgb[3 * i + 2] = w * gi2;
    T = T_next;
  }
}

extern "C" int pvd_composite_padded_bwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* delta_depth, const uint8_t* mask, const float* weights,
    int n_rays, int S, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_weights, float* d_sigma,
    float* d_rgb, void* stream) {
  if (n_rays <= 0) return 0;
  const int ray_threads = 64;
  composite_padded_bwd_kernel<<<(n_rays + ray_threads - 1) / ray_threads,
                                ray_threads, 0, (cudaStream_t)stream>>>(
      sigmas, rgbs, dt, delta_depth, mask, weights, n_rays, S, g_ws, g_depth,
      g_image, g_weights, d_sigma, d_rgb);
  return (int)cudaGetLastError();
}
