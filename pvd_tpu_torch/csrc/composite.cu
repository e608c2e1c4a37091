// K3: compositing of a compacted sample stream, forward; K6: its backward;
// K8, K9: the padded composite, forward and backward (below).
//
// Replaces pvd_tpu/ops/composite.py:28 composite_rays_compact.  The TPU
// version takes the segmented exclusive transmittance with a log-depth
// associative_scan over (value, reset) pairs and sums per ray with one
// scatter-add; on the GPU each ray walks its own contiguous slot range.
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
// only and zeroes the weights of invalid slots; pass 2 (one thread per ray)
// composites its range in order.  A ray with no valid slot keeps the zeroed
// empty range and writes zeros.  No atomics: every output has one writer.
//
// Bound on the H100: memory, and at these sizes launch latency.  A 4096-ray
// chunk at budget 65,536 reads 37 B per slot and writes 4 B per slot plus
// 20 B per ray (2.5 MB, under a microsecond at 3.35 TB/s).  Pass 2 has only
// one thread per ray and its loads stride across rays; the ranges are short
// (16 slots per ray at the 1x budget) and the data stays in L2.

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
// positions.  Bound: memory (37 B read and 16 B written per slot); like K3
// it is a serial chain of L2 loads per ray.

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

__global__ void composite_kernel(const float* __restrict__ sigmas,
                                 const float* __restrict__ rgbs,
                                 const float* __restrict__ dts,
                                 const float* __restrict__ t_cum,
                                 const int* __restrict__ start,
                                 const int* __restrict__ end, int n_rays,
                                 int early_stop, float* __restrict__ weights,
                                 float* __restrict__ ws_out,
                                 float* __restrict__ depth_out,
                                 float* __restrict__ image_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int e = end[r];
  float T = 1.f, ws = 0.f, depth = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int i = start[r]; i < e; ++i) {
    if (early_stop && T < 1e-4f) {
      // T only falls from here on: every later weight is zero
      weights[i] = 0.f;
      continue;
    }
    const float alpha =
        __fsub_rn(1.f, expf(__fmul_rn(-sigmas[i], dts[i])));
    const float w = __fmul_rn(alpha, T);
    weights[i] = w;
    ws = __fadd_rn(ws, w);
    depth = __fmaf_rn(w, t_cum[i], depth);
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

extern "C" int pvd_composite_compact_fwd(
    const float* sigmas, const float* rgbs, const float* dt,
    const float* t_cum, const long long* ray_id, const uint8_t* valid,
    int n_samples, int n_rays, int early_stop, int* bounds, float* weights,
    float* weights_sum, float* depth, float* image, void* stream) {
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
    // small blocks: one thread per ray is few threads, spread them over SMs
    const int ray_threads = 64;
    composite_kernel<<<(n_rays + ray_threads - 1) / ray_threads, ray_threads,
                       0, st>>>(
        sigmas, rgbs, dt, t_cum, bounds, bounds + n_rays, n_rays, early_stop,
        weights, weights_sum, depth, image);
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
