// K2: occupancy-grid ray march into [N, S] sample slots (dt_gamma == 0);
// K14: the same march on the geometric lattice (dt_gamma > 0).
//
// Replaces pvd_tpu/render/renderer.py:643 march_rays with the meaning of its
// plain-lattice path: _t_lattice (:199), _t_lattice_ln (:164), _dt_from_t
// (:213) and _occupancy_lookup (:231), then the slot assignment and
// delta_depth of :733-802.  The TPU's probe-mask marches (_probe_march_occ
// :340, _probe_march_occ_mc :436) and first-S compactions produce the same
// samples through gather-friendly layouts; none is needed here.
//
// Per ray: t0 = near (+ dt_min * u), then the lattice
//   K2:  t_k = t0 + k * dt_min, computed per k (one FMA, as XLA:CPU computes
//        it), dt_k = dt_min;
//   K14: t_{k+1} = t_k + dt_k, dt_k = clip(t_k * dt_gamma, dt_min, dt_max),
//        each op rounded on its own (__fmul_rn, the clip, __fadd_rn): XLA
//        cannot contract the multiply into the add across the clip,
// so t matches the plain version bit for bit.  Position clip(o + t * d,
// +-bound) (FMA), cascade = max of the frexp exponents of max|pos| and of
// the point's own dt*H/2, clipped to [0, C-1], cell int(0.5 * (pos /
// min(2^lvl, bound) + 1) * H) clipped to [0, H-1], with explicitly rounded
// operations so nvcc contracts nothing else.  A point is occupied if its bit
// is set and t < far; rays that miss the box carry near = far = FLT_MAX and
// produce no sample.
//   eval  (S >= L): lattice point k keeps slot k;
//   train (S <  L): the first S occupied points fill slots 0..S-1.
// Emits t, dt, mask, delta_depth = u - max(t0, u of the previous valid
// slot) with u = t + dt (0 on invalid slots), and t0.
//
// Bound on the H100: memory.  The outputs are N*S*(4+4+1+4) bytes per call
// (54.5 MB for a 4096-ray eval chunk at L = 1024); the bitfield (2 MB per
// cascade at H = 128) and the rays are read once and stay in L2.  Every
// lattice point costs a position, a cascade pick and three cell indices
// before its one-byte lookup; the cascade pick reads frexpf's exponent
// from the bits and divides by a power-of-two mip bound as a product with
// its exact reciprocal (the same IEEE results; a bound that is no power of
// two still divides).  Design (lookup, place): one WARP per ray, lanes
// over 32 consecutive lattice points, so stores are coalesced 128-byte rows
// and a 4096-ray chunk puts 131k threads on the card (one thread per ray
// would leave it 98% idle).  Slot ranks and the previous valid u come from
// warp ballots and shuffles; a running carry links the 32-point windows.
//
// K14's lattice is a serial recurrence: t_k needs t_{k-1}.  Its first
// design kept the warp layout by having all 32 lanes step the recurrence
// through each window in lockstep (lane i keeping step i): 32 dependent
// steps of 4 rounded ops and a select per window in every lane, ~190 warp
// instructions a window against K2's ~40, so it ran 23x its bound at the
// training batch (4096 rays x 64 slots) and 2x K2 at the eval chunk.  Each
// ray's chain is one serial thread of work, so now one lane computes it
// once: a block holds K14_RAYS marching warps, one ray each, and one chain
// warp whose lane r steps ray r's recurrence with the same four rounded
// ops in the same order and writes each t into a shared tile one round of
// K14_WIN windows ahead (double-buffered; rows padded to 32 K14_WIN + 1
// floats, so the eight lanes' stores fall in eight banks, and the last
// column holds the next round's first t).  The marching warps read their
// round's t from the tile, issue the round's K14_WIN lookups before
// ranking any (march_windows), and recompute dt from t by the closed form
// (geom_dt, _dt_from_t), the very op the chain applied to that t, so t,
// dt and mask stay bit-exact.  One barrier per round (__syncthreads_or of
// the marching warps' "still going") hands the tiles over and ends the
// block when every ray is done: a train-mode ray stops once it has S
// samples or its next round starts past far.  At the training batch it
// stays ~12x its byte bound; a chain that ran 8 steps at a time in their
// regime's one or two ops and checked them afterwards (fewer serial ops,
// more instructions) was slower, so the serial chain is not all of what
// holds it (PERF.md §7).  Measured and dropped (PERF.md §6): each
// ray's lattice up to far computed up front into shared memory (8 rays x
// 1024 floats) before any warp marches (the chain then runs alone while
// the marching warps wait), and rounds of one window.

#include <cuda_runtime.h>
#include <stdint.h>

#define K14_RAYS 8  // marching warps (rays) per K14 block
#define K14_WIN 4  // windows of 32 lattice points a K14 round

struct MarchParams {
  int n_rays;
  int n_steps;      // L, lattice length (max_steps)
  int max_samples;  // S, slots per ray
  int grid;         // H
  int cascades;     // C
  float bound;
  float dt_min;
  float mip_bound0;  // min(1, bound): the single-cascade mip bound
  float dt_gamma;    // K14 only
  float dt_max;      // K14 only: 2 sqrt(3) 2^(C-1) / H
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// frexpf's exponent of x >= 0, finite, where the caller clamps it to
// [0, C-1]: read from the bits (0 and subnormals give -126, frexpf <= 0)
__device__ __forceinline__ int frexp_exponent(float x) {
  return (int)((__float_as_uint(x) >> 23) & 0xffu) - 126;
}

// p / mb correctly rounded: the product with the exact reciprocal when mb
// is a power of two (every cascade's mip bound 2^level, and a power-of-two
// bound), which is the same IEEE result as the division
__device__ __forceinline__ float div_mip(float p, float mb) {
  const unsigned b = __float_as_uint(mb);
  if ((b & 0x7fffffu) == 0u)
    return __fmul_rn(p, __uint_as_float((254u << 23) - b));
  return __fdiv_rn(p, mb);
}

__device__ __forceinline__ int cell_of(float p, float mb, float H, int Hi) {
  const float c =
      __fmul_rn(__fmul_rn(0.5f, __fadd_rn(div_mip(p, mb), 1.f)), H);
  return clampi((int)c, 0, Hi - 1);
}

__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ bits,
                                         float px, float py, float pz,
                                         float dt, const MarchParams& p) {
  int level = 0;
  float mb = p.mip_bound0;
  if (p.cascades > 1) {
    const float mx = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    const int lp = clampi(frexp_exponent(mx), 0, p.cascades - 1);
    const int ld = clampi(
        frexp_exponent(__fmul_rn(__fmul_rn(dt, (float)p.grid), 0.5f)), 0,
        p.cascades - 1);
    level = lp > ld ? lp : ld;
    mb = fminf(__uint_as_float((127u + level) << 23), p.bound);
  }
  const float H = (float)p.grid;
  const int nx = cell_of(px, mb, H, p.grid);
  const int ny = cell_of(py, mb, H, p.grid);
  const int nz = cell_of(pz, mb, H, p.grid);
  const long long g = p.grid;
  const long long flat = ((long long)nx * g + ny) * g + nz + level * g * g * g;
  return bits[flat] != 0;
}

// K14: the step the geometric lattice takes from t (the chain's op, and
// _dt_from_t's closed form)
__device__ __forceinline__ float geom_dt(float t, const MarchParams& p) {
  return fminf(fmaxf(__fmul_rn(t, p.dt_gamma), p.dt_min), p.dt_max);
}

__device__ __forceinline__ float march_start(const float* __restrict__ nears,
                                             const float* __restrict__ u,
                                             long long ray,
                                             const MarchParams& p) {
  const float t0 = nears[ray];
  return u != nullptr ? __fmaf_rn(p.dt_min, u[ray], t0) : t0;
}

struct MarchOut {
  float* t;
  float* dt;
  uint8_t* mask;
  float* dd;
};

// one ray's geometry and its running state across windows
struct RayMarch {
  float t0, far, ox, oy, oz, dx, dy, dz;
  long long row;  // ray * S
  float carry;    // max(t0, u of the last valid point so far)
  int count;      // train mode: slots filled so far
};

__device__ __forceinline__ RayMarch ray_of(const float* __restrict__ rays_o,
                                           const float* __restrict__ rays_d,
                                           const float* __restrict__ fars,
                                           float t0, long long ray,
                                           const MarchParams& p) {
  RayMarch r;
  r.t0 = t0;
  r.far = fars[ray];
  r.ox = rays_o[3 * ray];
  r.oy = rays_o[3 * ray + 1];
  r.oz = rays_o[3 * ray + 2];
  r.dx = rays_d[3 * ray];
  r.dy = rays_d[3 * ray + 1];
  r.dz = rays_d[3 * ray + 2];
  r.row = ray * (long long)p.max_samples;
  r.carry = t0;
  r.count = 0;
  return r;
}

// lattice point k of ray r at t with step dt: occupied?  The lookup
// address is valid for any t (the position is clipped, the cell clamped),
// so the load needs no branch and several windows' loads can be in flight
__device__ __forceinline__ bool lookup(const uint8_t* __restrict__ bits,
                                       const MarchParams& p,
                                       const RayMarch& r, int k, float t,
                                       float dt) {
  const float px = fminf(fmaxf(__fmaf_rn(t, r.dx, r.ox), -p.bound), p.bound);
  const float py = fminf(fmaxf(__fmaf_rn(t, r.dy, r.oy), -p.bound), p.bound);
  const float pz = fminf(fmaxf(__fmaf_rn(t, r.dz, r.oz), -p.bound), p.bound);
  const bool bit = occupied(bits, px, py, pz, dt, p);
  return k < p.n_steps && t < r.far && bit;
}

// one 32-point window of ray r, the whole warp: lane's lattice point k =
// base + lane sits at t with step dt and is `occ`; ranks it among the
// ray's occupied points and writes its slot
__device__ __forceinline__ void place(const MarchParams& p, RayMarch& r,
                                      int base, float t, float dt, bool occ,
                                      const MarchOut& o) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int k = base + lane;
  const int L = p.n_steps, S = p.max_samples;
  const unsigned ball = __ballot_sync(FULL, occ);
  const float uu = __fadd_rn(t, dt);
  const unsigned below = ball & ((1u << lane) - 1u);
  const float u_prev = __shfl_sync(FULL, uu, below ? 31 - __clz(below) : 0);
  const float prev = fmaxf(below ? u_prev : r.carry, r.t0);
  const float dd = __fsub_rn(uu, prev);
  if (S >= L) {  // eval: lattice point k keeps slot k
    if (k < L) {
      o.t[r.row + k] = occ ? t : 0.f;
      o.dt[r.row + k] = occ ? dt : 0.f;
      o.mask[r.row + k] = occ;
      o.dd[r.row + k] = occ ? dd : 0.f;
    }
  } else {
    const int slot = r.count + __popc(below);
    if (occ && slot < S) {
      o.t[r.row + slot] = t;
      o.dt[r.row + slot] = dt;
      o.mask[r.row + slot] = 1;
      o.dd[r.row + slot] = dd;
    }
    r.count += __popc(ball);
  }
  if (ball) r.carry = fmaxf(r.carry, __shfl_sync(FULL, uu, 31 - __clz(ball)));
}

// K14: K14_WIN windows of ray r from the lattice row `lat` (the t of
// lattice points base, base + 1, ...), their lookups issued before any is
// ranked
__device__ __forceinline__ void march_windows(const uint8_t* __restrict__ bits,
                                              const MarchParams& p,
                                              RayMarch& r, int base,
                                              const float* lat,
                                              const MarchOut& o) {
  const int lane = threadIdx.x & 31;
  float t[K14_WIN], dt[K14_WIN];
  bool occ[K14_WIN];
#pragma unroll
  for (int j = 0; j < K14_WIN; ++j) {
    t[j] = lat[32 * j + lane];
    dt[j] = geom_dt(t[j], p);
    occ[j] = lookup(bits, p, r, base + 32 * j + lane, t[j], dt[j]);
  }
#pragma unroll
  for (int j = 0; j < K14_WIN; ++j)
    place(p, r, base + 32 * j, t[j], dt[j], occ[j], o);
}

// the slots no point filled, the whole warp: eval's padding past L, train's
// tail
__device__ __forceinline__ void fill_tail(const MarchParams& p,
                                          const RayMarch& r,
                                          const MarchOut& o) {
  const int L = p.n_steps, S = p.max_samples;
  const int filled = S >= L ? L : (r.count < S ? r.count : S);
  for (int s = filled + (threadIdx.x & 31); s < S; s += 32) {
    o.t[r.row + s] = 0.f;
    o.dt[r.row + s] = 0.f;
    o.mask[r.row + s] = 0;
    o.dd[r.row + s] = 0.f;
  }
}

__global__ void march_rays_kernel(const float* __restrict__ rays_o,
                                  const float* __restrict__ rays_d,
                                  const float* __restrict__ nears,
                                  const float* __restrict__ fars,
                                  const float* __restrict__ u,
                                  const uint8_t* __restrict__ bits,
                                  MarchParams p, MarchOut o,
                                  float* __restrict__ t0_out) {
  const long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= p.n_rays) return;  // whole warps leave together
  const float t0 = march_start(nears, u, ray, p);
  if (lane == 0) t0_out[ray] = t0;
  RayMarch r = ray_of(rays_o, rays_d, fars, t0, ray, p);
  for (int base = 0; base < p.n_steps; base += 32) {
    const int k = base + lane;
    const float t = __fmaf_rn((float)k, p.dt_min, t0);
    bool occ = false;
    if (k < p.n_steps && t < r.far) occ = lookup(bits, p, r, k, t, p.dt_min);
    place(p, r, base, t, p.dt_min, occ, o);
    if (p.max_samples < p.n_steps && r.count >= p.max_samples) break;
  }
  fill_tail(p, r, o);
}

// K14's chain lane: the next n lattice points of its ray from tc into
// row[0..n-1], the following point into row[n]
__device__ __forceinline__ void chain_points(float* __restrict__ row, int n,
                                             float& tc, const MarchParams& p) {
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    row[j] = tc;
    tc = __fadd_rn(tc, geom_dt(tc, p));
  }
  row[n] = tc;
}

__global__ void __launch_bounds__(32 * (K14_RAYS + 1))
    march_rays_geom_kernel(const float* __restrict__ rays_o,
                           const float* __restrict__ rays_d,
                           const float* __restrict__ nears,
                           const float* __restrict__ fars,
                           const float* __restrict__ u,
                           const uint8_t* __restrict__ bits, MarchParams p,
                           MarchOut o, float* __restrict__ t0_out) {
  constexpr int PTS = 32 * K14_WIN;  // lattice points a round
  __shared__ float tile[2][K14_RAYS][PTS + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray0 = (long long)blockIdx.x * K14_RAYS;
  const int L = p.n_steps, S = p.max_samples;
  // warp K14_RAYS: lane r < K14_RAYS steps ray ray0 + r's recurrence
  const bool chain =
      warp == K14_RAYS && lane < K14_RAYS && ray0 + lane < p.n_rays;
  float tc = 0.f;
  if (chain) {
    tc = march_start(nears, u, ray0 + lane, p);
    chain_points(tile[0][lane], PTS, tc, p);
  }
  const long long ray = ray0 + warp;
  const bool marcher = warp < K14_RAYS && ray < p.n_rays;
  RayMarch r;
  if (marcher) {
    const float t0 = march_start(nears, u, ray, p);
    if (lane == 0) t0_out[ray] = t0;
    r = ray_of(rays_o, rays_d, fars, t0, ray, p);
  }
  bool live = marcher;
  __syncthreads();
  for (int base = 0, b = 0; base < L; base += PTS, b ^= 1) {
    if (chain && base + PTS < L) chain_points(tile[b ^ 1][lane], PTS, tc, p);
    if (live) {
      march_windows(bits, p, r, base, tile[b][warp], o);
      // t is monotone: past far no later point is occupied
      if (S < L) live = r.count < S && tile[b][warp][PTS] < r.far;
    }
    if (!__syncthreads_or(live)) break;
  }
  if (marcher) fill_tail(p, r, o);
}

extern "C" int pvd_march_rays(const float* rays_o, const float* rays_d,
                              const float* nears, const float* fars,
                              const float* u, const uint8_t* bitfield,
                              MarchParams p, float* t, float* dt,
                              uint8_t* mask, float* delta_depth, float* t0,
                              void* stream) {
  if (p.n_rays == 0) return 0;
  const int threads = 256;  // 8 rays per block
  const long long blocks = ((long long)p.n_rays * 32 + threads - 1) / threads;
  const MarchOut o = {t, dt, mask, delta_depth};
  march_rays_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, nears, fars, u, bitfield, p, o, t0);
  return (int)cudaGetLastError();
}

extern "C" int pvd_march_rays_geom(const float* rays_o, const float* rays_d,
                                   const float* nears, const float* fars,
                                   const float* u, const uint8_t* bitfield,
                                   MarchParams p, float* t, float* dt,
                                   uint8_t* mask, float* delta_depth,
                                   float* t0, void* stream) {
  if (p.n_rays == 0) return 0;
  const long long blocks = ((long long)p.n_rays + K14_RAYS - 1) / K14_RAYS;
  const MarchOut o = {t, dt, mask, delta_depth};
  march_rays_geom_kernel<<<(unsigned)blocks, 32 * (K14_RAYS + 1), 0,
                           (cudaStream_t)stream>>>(
      rays_o, rays_d, nears, fars, u, bitfield, p, o, t0);
  return (int)cudaGetLastError();
}
