// K2: occupancy-grid ray march into [N, S] sample slots (dt_gamma == 0).
//
// Replaces pvd_tpu/render/renderer.py:643 march_rays with the meaning of its
// plain-lattice path: _t_lattice (:199), _dt_from_t (:213) and
// _occupancy_lookup (:231), then the slot assignment and delta_depth of
// :733-802.  The TPU's probe-mask marches (_probe_march_occ :340,
// _probe_march_occ_mc :436) and first-S compactions produce the same
// samples through gather-friendly layouts; none is needed here.
//
// Per ray: t0 = near (+ dt_min * u), lattice t_k = t0 + k * dt_min computed
// per k (one FMA, as XLA:CPU computes it, so t matches the plain version
// bit for bit), position clip(o + t * d, +-bound) (FMA), cascade = max of
// the frexp exponents of max|pos| and dt*H/2 clipped to [0, C-1], cell
// int(0.5 * (pos / min(2^lvl, bound) + 1) * H) clipped to [0, H-1], with
// explicitly rounded operations so nvcc contracts nothing else.  A point is
// occupied if its bit is set and t < far; rays that miss the box carry
// near = far = FLT_MAX and produce no sample.
//   eval  (S >= L): lattice point k keeps slot k;
//   train (S <  L): the first S occupied points fill slots 0..S-1.
// Emits t, dt, mask, delta_depth = u - max(t0, u of the previous valid
// slot) with u = t + dt (0 on invalid slots), and t0.
//
// Bound on the H100: memory.  The outputs are N*S*(4+4+1+4) bytes per call
// (54.5 MB for a 4096-ray eval chunk at L = 1024); the bitfield (2 MB at
// H = 128) and the rays are read once and stay in L2.  Design: one WARP per
// ray, lanes over 32 consecutive lattice points, so stores are coalesced
// 128-byte rows and a 4096-ray chunk puts 131k threads on the card (one
// thread per ray would leave it 98% idle).  Slot ranks and the previous
// valid u come from warp ballots and shuffles; a running carry links the
// 32-point windows.

#include <cuda_runtime.h>
#include <stdint.h>

struct MarchParams {
  int n_rays;
  int n_steps;      // L, lattice length (max_steps)
  int max_samples;  // S, slots per ray
  int grid;         // H
  int cascades;     // C
  float bound;
  float dt_min;
  float mip_bound0;  // min(1, bound): the single-cascade mip bound
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int cell_of(float p, float mb, float H, int Hi) {
  const float c = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fdiv_rn(p, mb), 1.f)),
                            H);
  return clampi((int)c, 0, Hi - 1);
}

__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ bits,
                                         float px, float py, float pz,
                                         const MarchParams& p) {
  int level = 0;
  float mb = p.mip_bound0;
  if (p.cascades > 1) {
    int e;
    const float mx = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    frexpf(mx, &e);
    const int lp = clampi(e, 0, p.cascades - 1);
    frexpf(__fmul_rn(__fmul_rn(p.dt_min, (float)p.grid), 0.5f), &e);
    const int ld = clampi(e, 0, p.cascades - 1);
    level = lp > ld ? lp : ld;
    mb = fminf(ldexpf(1.f, level), p.bound);
  }
  const float H = (float)p.grid;
  const int nx = cell_of(px, mb, H, p.grid);
  const int ny = cell_of(py, mb, H, p.grid);
  const int nz = cell_of(pz, mb, H, p.grid);
  const long long g = p.grid;
  const long long flat = ((long long)nx * g + ny) * g + nz + level * g * g * g;
  return bits[flat] != 0;
}

__global__ void march_rays_kernel(const float* __restrict__ rays_o,
                                  const float* __restrict__ rays_d,
                                  const float* __restrict__ nears,
                                  const float* __restrict__ fars,
                                  const float* __restrict__ u,
                                  const uint8_t* __restrict__ bits,
                                  MarchParams p, float* __restrict__ t_out,
                                  float* __restrict__ dt_out,
                                  uint8_t* __restrict__ mask_out,
                                  float* __restrict__ dd_out,
                                  float* __restrict__ t0_out) {
  const unsigned FULL = 0xffffffffu;
  const long long ray = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= p.n_rays) return;  // whole warps leave together
  const float dt = p.dt_min;
  float t0 = nears[ray];
  if (u != nullptr) t0 = __fmaf_rn(dt, u[ray], t0);
  if (lane == 0) t0_out[ray] = t0;
  const float far = fars[ray];
  const float ox = rays_o[3 * ray], oy = rays_o[3 * ray + 1],
              oz = rays_o[3 * ray + 2];
  const float dx = rays_d[3 * ray], dy = rays_d[3 * ray + 1],
              dz = rays_d[3 * ray + 2];
  const int L = p.n_steps, S = p.max_samples;
  const bool eval_mode = S >= L;
  const long long row = ray * (long long)S;
  const unsigned below_mask = (1u << lane) - 1u;

  float carry = t0;  // max(t0, u of the last valid point so far)
  int count = 0;     // train mode: slots filled so far
  for (int base = 0; base < L; base += 32) {
    const int k = base + lane;
    const float t = __fmaf_rn((float)k, dt, t0);
    bool occ = false;
    if (k < L && t < far) {
      const float px = fminf(fmaxf(__fmaf_rn(t, dx, ox), -p.bound), p.bound);
      const float py = fminf(fmaxf(__fmaf_rn(t, dy, oy), -p.bound), p.bound);
      const float pz = fminf(fmaxf(__fmaf_rn(t, dz, oz), -p.bound), p.bound);
      occ = occupied(bits, px, py, pz, p);
    }
    const unsigned ball = __ballot_sync(FULL, occ);
    const float uu = __fadd_rn(t, dt);
    const unsigned below = ball & below_mask;
    const float u_prev =
        __shfl_sync(FULL, uu, below ? 31 - __clz(below) : 0);
    const float prev = fmaxf(below ? u_prev : carry, t0);
    const float dd = __fsub_rn(uu, prev);
    if (eval_mode) {
      if (k < L) {
        t_out[row + k] = occ ? t : 0.f;
        dt_out[row + k] = occ ? dt : 0.f;
        mask_out[row + k] = occ;
        dd_out[row + k] = occ ? dd : 0.f;
      }
    } else {
      const int slot = count + __popc(below);
      if (occ && slot < S) {
        t_out[row + slot] = t;
        dt_out[row + slot] = dt;
        mask_out[row + slot] = 1;
        dd_out[row + slot] = dd;
      }
      count += __popc(ball);
    }
    if (ball) {
      carry = fmaxf(carry, __shfl_sync(FULL, uu, 31 - __clz(ball)));
    }
    if (!eval_mode && count >= S) break;
  }
  // slots no point filled: eval's padding past L, train's tail
  const int filled = eval_mode ? L : (count < S ? count : S);
  for (int s = filled + lane; s < S; s += 32) {
    t_out[row + s] = 0.f;
    dt_out[row + s] = 0.f;
    mask_out[row + s] = 0;
    dd_out[row + s] = 0.f;
  }
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
  march_rays_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, nears, fars, u, bitfield, p, t, dt, mask, delta_depth,
      t0);
  return (int)cudaGetLastError();
}
