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
// two still divides).  K14 (lookup, place): one WARP per ray, lanes over
// 32 consecutive lattice points, so stores are coalesced 128-byte rows and
// a 4096-ray chunk puts 131k threads on the card (one thread per ray would
// leave it 98% idle).  Slot ranks and the previous valid u come from warp
// ballots and shuffles; a running carry links the 32-point windows.
//
// K2's first design was that warp walking its ray one 32-point window at
// a time, each window's lookups waiting on the last one's ranking, and all
// 32 windows to L however early the ray passed far: ~12x its byte bound at
// the exact teacher's training batch (8192 rays into 96 slots) and 2x at
// the eval chunk.  Its work is per lattice point, so the design now cuts
// that work: a lane holds 4 consecutive lattice points of a 128-point
// round, issues their 4 lookups together, and ranks them with 4 ballots
// and one shuffle a round (march_rays_kernel); the ray stops at the first
// round that starts past far; lookup (K14's too) takes each cell without
// a float-to-int conversion (cell_of) and the index in 32 bits; eval mode
// writes a lane's 4 slots as float4s (a uchar4 for the mask); train mode
// stages a round's samples in shared memory and writes them to
// consecutive slots with consecutive lanes.  t, dt, mask and t0 stay
// bit-exact (the same ops on the same values).  On the H100 (PERF.md §6):
// 0.58x the first design at the training batch (7x its bound), 0.64x at
// the A/B batch, 0.74x at the eval chunk (1.5x its bound).  Measured and
// dropped: rounds of 1, 2, 4 and 8 windows of one point a lane (each
// gained less than the 4-point lanes), K2 at 32 registers (spills), and
// 4-point lanes each storing its own train samples (slower on a dense
// grid: strided stores).
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
#define K2_THREADS 256  // K2: 8 rays (warps) a block
#define K2_ROUND 128  // lattice points a K2 round: 4 a lane

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

// the cascade of a point and its mip bound min(2^level, bound): the larger
// frexp exponent of max|pos| and of the point's own dt*H/2, each clamped
// to [0, C-1]
__device__ __forceinline__ int cascade_of(float px, float py, float pz,
                                          float dt, const MarchParams& p,
                                          float& mb) {
  mb = p.mip_bound0;
  if (p.cascades == 1) return 0;
  const float mx = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
  const int lp = clampi(frexp_exponent(mx), 0, p.cascades - 1);
  const int ld = clampi(
      frexp_exponent(__fmul_rn(__fmul_rn(dt, (float)p.grid), 0.5f)), 0,
      p.cascades - 1);
  const int level = lp > ld ? lp : ld;
  mb = fminf(__uint_as_float((127u + level) << 23), p.bound);
  return level;
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

// the cell int(0.5 * (q / mb + 1) * H) clamped to [0, H-1] with no
// float-to-int conversion: trunc(c) clamped to [0, H-1] is trunc of c
// clamped to [0, H-1] first, and for v in [0, H-1] (H - 1 < 2^23) the
// mantissa of v + 2^23 rounded down is trunc(v)
__device__ __forceinline__ int cell_of(float q, float mb, float H,
                                       float h_max) {
  const float c =
      __fmul_rn(__fmul_rn(0.5f, __fadd_rn(div_mip(q, mb), 1.f)), H);
  const float v = fminf(fmaxf(c, 0.f), h_max);
  return (int)(__float_as_uint(__fadd_rd(v, 8388608.f)) & 0x7fffffu);
}

// lattice point k of ray r at t with step dt: occupied?  The lookup
// address is valid for any t (the position is clipped, the cell clamped),
// so the load needs no branch and several points' loads can be in flight;
// the index is 32-bit (the entries check that C * H^3 fits)
__device__ __forceinline__ bool lookup(const uint8_t* __restrict__ bits,
                                       const MarchParams& p,
                                       const RayMarch& r, int k, float t,
                                       float dt) {
  const float px = fminf(fmaxf(__fmaf_rn(t, r.dx, r.ox), -p.bound), p.bound);
  const float py = fminf(fmaxf(__fmaf_rn(t, r.dy, r.oy), -p.bound), p.bound);
  const float pz = fminf(fmaxf(__fmaf_rn(t, r.dz, r.oz), -p.bound), p.bound);
  float mb;
  const int level = cascade_of(px, py, pz, dt, p, mb);
  const int g = p.grid;
  const float H = (float)g, h_max = (float)(g - 1);
  const int nx = cell_of(px, mb, H, h_max), ny = cell_of(py, mb, H, h_max),
            nz = cell_of(pz, mb, H, h_max);
  const bool bit = bits[(nx * g + ny) * g + nz + level * g * g * g] != 0;
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

// the slots no point filled, the whole warp: in eval mode those of the
// lattice points from `placed` on (past far) and the padding past L, in
// train mode the tail past the ray's samples
__device__ __forceinline__ void fill_tail(const MarchParams& p,
                                          const RayMarch& r, int placed,
                                          const MarchOut& o) {
  const int L = p.n_steps, S = p.max_samples;
  const int filled =
      S >= L ? (placed < L ? placed : L) : (r.count < S ? r.count : S);
  for (int s = filled + (threadIdx.x & 31); s < S; s += 32) {
    o.t[r.row + s] = 0.f;
    o.dt[r.row + s] = 0.f;
    o.mask[r.row + s] = 0;
    o.dd[r.row + s] = 0.f;
  }
}

// K2: a warp per ray, lane i holding lattice points base + 4i .. base + 4i
// + 3 of a round of 128 (all their lookups issued before any is ranked);
// the ray stops at the first round that starts past far (t is monotone in
// k) or, in train mode, once it has S samples.  Within a round a point's
// slot rank is the ray's count, the occupied points of the lanes below (4
// ballots) and its lane's earlier ones; the u = t + dt before it is its
// lane's previous occupied point's, else the last of the lanes below
// (one shuffle), else the carry.  Eval mode writes a lane's 4 slots as one
// float4 (uchar4 for the mask) where vec (S % 4 == 0, aligned outputs);
// train mode stages the round's samples in shared memory and writes them
// to consecutive slots with consecutive lanes.
__global__ void __launch_bounds__(K2_THREADS)
    march_rays_kernel(const float* __restrict__ rays_o,
                      const float* __restrict__ rays_d,
                      const float* __restrict__ nears,
                      const float* __restrict__ fars,
                      const float* __restrict__ u,
                      const uint8_t* __restrict__ bits, MarchParams p,
                      MarchOut o, float* __restrict__ t0_out, bool vec) {
  const unsigned FULL = 0xffffffffu;
  __shared__ float stage[K2_THREADS / 32][2][K2_ROUND];
  const long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (ray >= p.n_rays) return;  // whole warps leave together
  const float t0 = march_start(nears, u, ray, p);
  if (lane == 0) t0_out[ray] = t0;
  RayMarch r = ray_of(rays_o, rays_d, fars, t0, ray, p);
  const int L = p.n_steps, S = p.max_samples;
  const float dtm = p.dt_min;
  const unsigned below_me = (1u << lane) - 1u;
  int base = 0;
  for (; base < L; base += K2_ROUND) {
    if (!(__fmaf_rn((float)base, dtm, t0) < r.far)) break;
    const int k0 = base + 4 * lane;
    float t[4], uu[4], dd[4];
    bool occ[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t[j] = __fmaf_rn((float)(k0 + j), dtm, t0);
      occ[j] = lookup(bits, p, r, k0 + j, t[j], dtm);
      uu[j] = __fadd_rn(t[j], dtm);
    }
    const unsigned any =
        __ballot_sync(FULL, occ[0] || occ[1] || occ[2] || occ[3]);
    const float last =
        occ[3] ? uu[3] : (occ[2] ? uu[2] : (occ[1] ? uu[1] : uu[0]));
    const unsigned lower = any & below_me;
    const float u_lower = __shfl_sync(FULL, last, lower ? 31 - __clz(lower) : 0);
    float prev = lower ? u_lower : r.carry;
    int rank = 0, total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = __ballot_sync(FULL, occ[j]);
      rank += __popc(b & below_me);
      total += __popc(b);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dd[j] = __fsub_rn(uu[j], fmaxf(prev, r.t0));
      if (occ[j]) prev = uu[j];
    }
    if (S >= L) {  // eval: lattice point k keeps slot k
      if (vec && k0 + 3 < L) {
        const long long at = r.row + k0;
        *reinterpret_cast<float4*>(o.t + at) =
            make_float4(occ[0] ? t[0] : 0.f, occ[1] ? t[1] : 0.f,
                        occ[2] ? t[2] : 0.f, occ[3] ? t[3] : 0.f);
        *reinterpret_cast<float4*>(o.dt + at) =
            make_float4(occ[0] ? dtm : 0.f, occ[1] ? dtm : 0.f,
                        occ[2] ? dtm : 0.f, occ[3] ? dtm : 0.f);
        *reinterpret_cast<uchar4*>(o.mask + at) =
            make_uchar4(occ[0], occ[1], occ[2], occ[3]);
        *reinterpret_cast<float4*>(o.dd + at) =
            make_float4(occ[0] ? dd[0] : 0.f, occ[1] ? dd[1] : 0.f,
                        occ[2] ? dd[2] : 0.f, occ[3] ? dd[3] : 0.f);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + j < L) {
            const long long at = r.row + k0 + j;
            o.t[at] = occ[j] ? t[j] : 0.f;
            o.dt[at] = occ[j] ? dtm : 0.f;
            o.mask[at] = occ[j];
            o.dd[at] = occ[j] ? dd[j] : 0.f;
          }
      }
    } else {  // train: the first S occupied points fill slots 0..S-1
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (occ[j]) {
          stage[w][0][rank] = t[j];
          stage[w][1][rank] = dd[j];
          ++rank;
        }
      __syncwarp();
      const int n = min(total, S - r.count);
      for (int q = lane; q < n; q += 32) {
        const long long at = r.row + r.count + q;
        o.t[at] = stage[w][0][q];
        o.dt[at] = dtm;
        o.mask[at] = 1;
        o.dd[at] = stage[w][1][q];
      }
      __syncwarp();
    }
    r.count += total;
    if (any) r.carry = fmaxf(r.carry, __shfl_sync(FULL, last, 31 - __clz(any)));
    if (S < L && r.count >= S) break;
  }
  fill_tail(p, r, base, o);
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
  if (marcher) fill_tail(p, r, L, o);
}

// C * H^3 cells must fit a 32-bit index (lookup)
static bool index_fits(const MarchParams& p) {
  return (long long)p.cascades * p.grid * p.grid * p.grid < (1LL << 31);
}

extern "C" int pvd_march_rays(const float* rays_o, const float* rays_d,
                              const float* nears, const float* fars,
                              const float* u, const uint8_t* bitfield,
                              MarchParams p, float* t, float* dt,
                              uint8_t* mask, float* delta_depth, float* t0,
                              void* stream) {
  if (p.n_rays == 0) return 0;
  if (!index_fits(p)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      ((long long)p.n_rays * 32 + K2_THREADS - 1) / K2_THREADS;
  const MarchOut o = {t, dt, mask, delta_depth};
  const bool vec = p.max_samples % 4 == 0 &&
                   ((uintptr_t)t | (uintptr_t)dt | (uintptr_t)mask |
                    (uintptr_t)delta_depth) % 16 == 0;
  march_rays_kernel<<<(unsigned)blocks, K2_THREADS, 0,
                      (cudaStream_t)stream>>>(rays_o, rays_d, nears, fars, u,
                                              bitfield, p, o, t0, vec);
  return (int)cudaGetLastError();
}

extern "C" int pvd_march_rays_geom(const float* rays_o, const float* rays_d,
                                   const float* nears, const float* fars,
                                   const float* u, const uint8_t* bitfield,
                                   MarchParams p, float* t, float* dt,
                                   uint8_t* mask, float* delta_depth,
                                   float* t0, void* stream) {
  if (p.n_rays == 0) return 0;
  if (!index_fits(p)) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)p.n_rays + K14_RAYS - 1) / K14_RAYS;
  const MarchOut o = {t, dt, mask, delta_depth};
  march_rays_geom_kernel<<<(unsigned)blocks, 32 * (K14_RAYS + 1), 0,
                           (cudaStream_t)stream>>>(
      rays_o, rays_d, nears, fars, u, bitfield, p, o, t0);
  return (int)cudaGetLastError();
}
