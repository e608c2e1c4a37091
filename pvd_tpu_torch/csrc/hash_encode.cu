// K1: multi-resolution hash-grid encode (INGP), forward, D = 3, C = 2;
// K7: its table gradient;
// K10: the cell-packed levels' encode; K11: the cell table's gradient;
// K12: K1 on a 2-D grid (the background model's); K13: its table gradient;
// K15: the baked dense levels' encode; K16: the bake of a frozen table.
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

// K12: the D = 2 encode, replacing pvd_tpu/ops/hashgrid.py:533 hash_encode
// at input_dim 2 as pvd_tpu/models/api.py:127 background_rgb calls it: the
// polar coordinates of the background sphere, (polar + 1) / 2 in [0, 1]^2,
// on bg_grid_spec's 4 levels x 2 channels (resolutions 16/81/407/2048:
// levels 0-2 dense and row-major, c0 + c1 * side; level 3 hashed,
// (c0 * 1 ^ c1 * 2654435761) & (2^19 - 1)), a 697,776 x 2 table (5.6 MB).
// It is K1's body instantiated at D = 2: the same x01 * scale + 0.5 FMA,
// bilinear weights over 4 corners and the same per-(point, level) thread;
// inputs outside [0, 1]^2 give 0.  Bound on the H100: memory, 4 rows of
// 8 B per (point, level) from a table that fits the L2, 8 B read and 32 B
// written per point; one launch per composited batch, on N rays, not on
// the samples, so it is small beside K1.
//
// K13: its table gradient, g_table[offset_l + row(corner k)] += w_k * g[n, l]
// into a zeroed dense [697,776, 2] gradient, with K12's corner rows and
// weights (corner_setup, corner_weight: the x01 * scale + 0.5 FMA) and the
// products w_k * g rounded as K7 rounds them; pairs with g = (0, 0) and
// points outside the square add nothing.  Bound on the H100: memory, the
// wrapper's 5.6 MB zero-fill (inside the timed call, as for the index_add_
// yardstick) plus 40 B read per point (x01 and its upstream row); every
// add lands on a table of 5.6 MB that sits in the 50 MB L2, so what limits
// the kernel is how many atomics the L2 must serialize on one address.
// The first design was K7's body at D = 2: one thread per (point, level)
// issuing 8 scalar fp32 atomics.  At a whole view (262,144 rays) level 0's
// 17^2 rows took ~2.1 M of them, ~3,600
// read-modify-writes per address in series at the L2, and the kernel ran
// ~300x its bound and ~1.9x one index_add_ of the same contributions.
// The design now (hash_encode2_bwd_kernel): one thread per point, a block
// per 128 consecutive points (neighbouring rays, so neighbouring polar
// cells), reading x01 once and the point's whole upstream row (two float4s
// at the 4 levels), both loads in flight together.  At each level the
// lanes of a warp whose points fall in one lattice cell (the same 4 rows)
// first sum their 8 contributions in registers (__match_any_sync, then a
// shuffle tree), and only the lowest of them adds, one float2 atomic per
// corner where the toolkit has them for sm_90 (else two scalar ones): a
// global add to one row serializes at the L2, so a warp's 32 rays in one
// cell cost one add instead of 32, and each add is half the first
// design's.  A block-private shared-memory copy of level 0 (2.3 KB) was
// timed too: it paid only when every block walked several tiles of points,
// at a whole view's 262,144 points (0.035 against 0.044 ms on the H100),
// which no training path sends (K13 takes one point per ray, 4,096 to
// 16,384 rays a step), and at the training batch its zero fill, barrier
// and flush cost more than they saved (PERF.md §6), so it is not built.  Each
// contribution is K12's product bit for bit; only the order of the sums
// changes (it varies from run to run), so the card check uses a relative
// tolerance.  K7 (D = 3) keeps the first design's encode_bwd on purpose:
// its redesign is later work, and its timed row must stay what it
// measured.
//
// K15: the baked dense levels' encode, replacing the baked branch of
// pvd_tpu/ops/hashgrid.py:533 hash_encode (:584-590, :635-646) for a frozen
// table.  The bake (K16) stores at every vertex of the finest dense level's
// lattice (side_f per axis) the features of all Ld dense levels, one row of
// Ld * 2 floats.  Per point: the finest dense level's base cell and 8
// trilinear weights exactly as K1 forms them (corner_setup, corner_weight:
// the x01 * scale + 0.5 FMA, zeros outside [0, 1]^3), then the 8 corner
// rows c0 + c1 * side_f + c2 * side_f^2 of the vertex table, and for each
// dense level j the weighted corner sum of its 2 floats into level slot
// level[j] of the [N, L * 2] output that K1 (the other corner levels) and
// K10 (the cell levels) fill too.  A point inside the cube never reaches
// past the far faces (base <= side_f - 2), where the JAX package's packed
// rows hold zeros.  The TPU packs the 8 neighbours into one row for its
// row-rate-bound gather engine; here one thread per point reads the 8 rows
// of Ld * 8 bytes (40 B at Ld 5) directly: pairs of rows (x, x + 1) are
// adjacent, so a point touches 4 runs of 80 B.  The corner sum runs in
// corner order with FMAs, not XLA's 0/1 matmul order.  The level loop is
// unrolled to PVD_MAX_BAKED with compile-time indices, so the by-value
// level list stays in registers and constant memory.
// Bound on the H100: memory.  12 B of x01 in and Ld * 8 B out per point,
// and the vertex table (15.6 MB at side 73, Ld 5) once, which fits the 50 MB
// L2; the 8 corner rows per point are L2 hits after the first touch.
//
// K16: the bake, replacing pvd_tpu/ops/hashgrid.py:461 build_baked_dense
// (its unpacked vertex table; ops/packing.pack_rows_3d is a TPU layout).
// One thread per (fine vertex, dense level j): the finest level (the last
// entry) copies its vertex's row; a coarser level evaluates its trilinear
// feature at the vertex from the base b and fraction f of each axis
// coordinate, computed on the host in float64 as the JAX package does
// (b clipped to [0, side_l - 2], so f extrapolates at the edges), with
// w = (wx * wy) * wz and acc = acc + row * w over the corners in the order
// k = dx + 2 dy + 4 dz, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn): the JAX package builds the table with eager ops,
// which XLA:CPU does not contract into FMAs, so K16 equals it bit for bit.
// Runs once per load_teacher.  Bound: memory, the fine level's rows read
// once and the vertex table written once.

#include <cuda_runtime.h>
#include <stdint.h>

#define PVD_MAX_LEVELS 32
#define PVD_MAX_BAKED 8
#define K13_LEVELS 4  // the background grid's (bg_grid_spec)
#define K13_THREADS 128

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

// Corner setup of one (point, level entry) of a D-dimensional grid: lattice
// base, fractions and level constants, computed exactly as the plain
// version does.
template <int D>
struct Corners {
  float f[D], g[D];  // fractions and 1 - fractions
  uint32_t i[D];     // lattice base
  uint32_t side;
  bool hashed;
};

template <int D>
__device__ __forceinline__ void load_point(const float* __restrict__ x01,
                                           long long n, float (&x)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = __ldg(x01 + D * n + d);
}

template <int D>
__device__ __forceinline__ Corners<D> corner_setup(const float (&x)[D], int l,
                                                   const HashLevels& lv) {
  Corners<D> c;
  const float s = lv.scale[l];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = __fmaf_rn(x[d], s, 0.5f);
    const float b = floorf(p);
    c.f[d] = __fsub_rn(p, b);
    c.g[d] = __fsub_rn(1.f, c.f[d]);
    c.i[d] = (uint32_t)(int)b;
  }
  c.side = (uint32_t)lv.side[l];
  c.hashed = lv.hashed[l] != 0;
  return c;
}

// Weight of corner k (bit d of k: +1 along dim d), multiplied left to right
// over the dimensions.
template <int D>
__device__ __forceinline__ float corner_weight(const Corners<D>& c, int k) {
  float w = (k & 1) ? c.f[0] : c.g[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    w = __fmul_rn(w, ((k >> d) & 1) ? c.f[d] : c.g[d]);
  return w;
}

__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

// Level-relative row of corner k: the xor-prime hash (mod 2^32) & mask on a
// hashed level, row-major c0 + c1 * side + c2 * side^2 on a dense one.
template <int D>
__device__ __forceinline__ uint32_t corner_row(const Corners<D>& c, int k,
                                               uint32_t hash_mask) {
  uint32_t h = 0u, r = 0u, stride = 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const uint32_t cd = c.i[d] + ((k >> d) & 1);
    h ^= cd * prime(d);
    r += cd * stride;
    stride *= c.side;
  }
  return c.hashed ? (h & hash_mask) : r;
}

// (x < 0) | (x > 1) in any dimension, as in hashgrid.py:571 (a NaN passes,
// like JAX's)
template <int D>
__device__ __forceinline__ bool outside(const float (&x)[D]) {
  bool o = false;
#pragma unroll
  for (int d = 0; d < D; ++d) o = o || x[d] < 0.f || x[d] > 1.f;
  return o;
}

// K1 (D = 3) and K12 (D = 2): one thread per (point, level entry).
template <int D>
__device__ __forceinline__ void encode_fwd(const float* __restrict__ x01,
                                           const float2* __restrict__ table,
                                           float2* __restrict__ out,
                                           long long n_points,
                                           const HashLevels& lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  float2* o = out + n * lv.out_levels + lv.level[l];
  float x[D];
  load_point<D>(x01, n, x);
  if (outside<D>(x)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners<D> c = corner_setup<D>(x, l, lv);
  const float2* tl = table + lv.offset[l];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    const float w = corner_weight<D>(c, k);
    const float2 v = __ldg(tl + corner_row<D>(c, k, lv.hash_mask));
    a0 = __fmaf_rn(w, v.x, a0);
    a1 = __fmaf_rn(w, v.y, a1);
  }
  *o = make_float2(a0, a1);
}

// K7 (D = 3): 2 * 2^D fp32 atomics per active pair.
template <int D>
__device__ __forceinline__ void encode_bwd(const float* __restrict__ x01,
                                           const float2* __restrict__ g,
                                           float* __restrict__ grad,
                                           long long n_points,
                                           const HashLevels& lv) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_points * lv.n_levels) return;
  const long long n = gid / lv.n_levels;
  const int l = (int)(gid - n * lv.n_levels);
  const float2 gv = g[n * lv.out_levels + lv.level[l]];
  if (gv.x == 0.f && gv.y == 0.f) return;
  float x[D];
  load_point<D>(x01, n, x);
  if (outside<D>(x)) return;
  const Corners<D> c = corner_setup<D>(x, l, lv);
  float* gl = grad + 2 * (long long)lv.offset[l];
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    const float w = corner_weight<D>(c, k);
    float* dst = gl + 2 * (long long)corner_row<D>(c, k, lv.hash_mask);
    atomicAdd(dst, __fmul_rn(w, gv.x));
    atomicAdd(dst + 1, __fmul_rn(w, gv.y));
  }
}

__global__ void hash_encode_fwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ table,
                                       float2* __restrict__ out,
                                       long long n_points, HashLevels lv) {
  encode_fwd<3>(x01, table, out, n_points, lv);
}

__global__ void hash_encode_bwd_kernel(const float* __restrict__ x01,
                                       const float2* __restrict__ g,
                                       float* __restrict__ grad,
                                       long long n_points, HashLevels lv) {
  encode_bwd<3>(x01, g, grad, n_points, lv);
}

__global__ void hash_encode2_fwd_kernel(const float* __restrict__ x01,
                                        const float2* __restrict__ table,
                                        float2* __restrict__ out,
                                        long long n_points, HashLevels lv) {
  encode_fwd<2>(x01, table, out, n_points, lv);
}

// K13: float2 atomic add into a global gradient row
__device__ __forceinline__ void add_row(float2* dst, float a, float b) {
#if PVD_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

// K13: per value v[j], the sum over the lanes of `peers` (the lanes whose
// key matched, __match_any_sync), left in the lowest of them; every lane
// of the warp takes part.  A tree over each group's lanes in lane order:
// log2(group size) rounds of J shuffles and one ballot (none when no lane
// shares its key).
template <int J>
__device__ __forceinline__ void peer_sum(unsigned peers, float (&v)[J]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the group's lanes above this one
  while (__any_sync(0xffffffffu, peers)) {
    const int next = __ffs(peers);  // 0: none left
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float t = __shfl_sync(0xffffffffu, v[j], (next - 1) & 31);
      if (next) v[j] += t;
    }
    peers &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

// K13: the K13_LEVELS levels in slots 0..3 of each upstream row (the
// entry checks it), unrolled so every per-level constant is read at a
// compile-time index of the by-value level list.  One thread per point; a
// lane past the end, outside the square or with g = (0, 0) at a level adds
// nothing there, but runs the warp votes.  At each level the lanes in one
// lattice cell (one key: the cell's base c0 + c1 * side) first sum their 8
// contributions in registers; the lowest of them adds the sums.
__global__ void __launch_bounds__(K13_THREADS)
    hash_encode2_bwd_kernel(const float* __restrict__ x01,
                            const float4* __restrict__ g,
                            float2* __restrict__ grad, long long n_points,
                            HashLevels lv) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float x[2] = {0.f, 0.f};
  float2 gv[K13_LEVELS];
  if (n < n_points) {  // both loads in flight at once
    const float4 a = __ldg(g + 2 * n), b = __ldg(g + 2 * n + 1);
    x[0] = __ldg(x01 + 2 * n);
    x[1] = __ldg(x01 + 2 * n + 1);
    gv[0] = make_float2(a.x, a.y);
    gv[1] = make_float2(a.z, a.w);
    gv[2] = make_float2(b.x, b.y);
    gv[3] = make_float2(b.z, b.w);
  } else {
#pragma unroll
    for (int l = 0; l < K13_LEVELS; ++l) gv[l] = make_float2(0.f, 0.f);
  }
  const bool in = n < n_points && !outside<2>(x);
#pragma unroll
  for (int l = 0; l < K13_LEVELS; ++l) {
    const bool add = in && (gv[l].x != 0.f || gv[l].y != 0.f);
    const Corners<2> c = corner_setup<2>(x, l, lv);
    const unsigned peers = __match_any_sync(
        0xffffffffu, add ? (int)(c.i[0] + c.i[1] * c.side) : -1);
    float v[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = corner_weight<2>(c, k);
      v[2 * k] = add ? __fmul_rn(w, gv[l].x) : 0.f;
      v[2 * k + 1] = add ? __fmul_rn(w, gv[l].y) : 0.f;
    }
    peer_sum<8>(peers, v);
    if (!add || __ffs(peers) - 1 != lane) continue;
    float2* gl = grad + lv.offset[l];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      add_row(gl + corner_row<2>(c, k, lv.hash_mask), v[2 * k],
              v[2 * k + 1]);
  }
}

// The cell row of one (point, cell level entry): corner 0's hashed row
// (the cell's base coordinate) plus the entry's block of the cell table.
__device__ __forceinline__ long long cell_row(const Corners<3>& c, int l,
                                              const HashLevels& lv) {
  return (long long)lv.offset[l] + corner_row<3>(c, 0, lv.hash_mask);
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
  float x[3];
  load_point<3>(x01, n, x);
  if (outside<3>(x)) {
    *o = make_float2(0.f, 0.f);
    return;
  }
  const Corners<3> c = corner_setup<3>(x, l, lv);
  const float4* r = cell + 4 * cell_row(c, l, lv);
  const float4 v[4] = {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight<3>(c, 2 * q);
    const float w1 = corner_weight<3>(c, 2 * q + 1);
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
  float x[3];
  load_point<3>(x01, n, x);
  if (outside<3>(x)) return;
  const Corners<3> c = corner_setup<3>(x, l, lv);
  float4* dst = grad + 4 * cell_row(c, l, lv);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w0 = corner_weight<3>(c, 2 * q);
    const float w1 = corner_weight<3>(c, 2 * q + 1);
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

// K15: one thread per point; entry j of lv is dense level j (slot
// level[j]); entry 0 carries the finest dense level's side and scale.
__global__ void hash_baked_fwd_kernel(const float* __restrict__ x01,
                                      const float2* __restrict__ baked,
                                      float2* __restrict__ out,
                                      long long n_points, HashLevels lv) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float2* o = out + n * lv.out_levels;
  const int ld = lv.n_levels;
  float x[3];
  load_point<3>(x01, n, x);
  if (outside<3>(x)) {
#pragma unroll
    for (int j = 0; j < PVD_MAX_BAKED; ++j)
      if (j < ld) o[lv.level[j]] = make_float2(0.f, 0.f);
    return;
  }
  const Corners<3> c = corner_setup<3>(x, 0, lv);
  float w[8];
  long long row[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = corner_weight<3>(c, k);
    row[k] = (long long)corner_row<3>(c, k, 0u) * ld;
  }
#pragma unroll
  for (int j = 0; j < PVD_MAX_BAKED; ++j) {
    if (j >= ld) break;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 v = __ldg(baked + row[k] + j);
      a0 = __fmaf_rn(w[k], v.x, a0);
      a1 = __fmaf_rn(w[k], v.y, a1);
    }
    o[lv.level[j]] = make_float2(a0, a1);
  }
}

// K16: one thread per (fine vertex, dense level entry j), j fastest so a
// warp writes whole rows of the vertex table.
__global__ void hash_bake_kernel(const float2* __restrict__ table,
                                 const int* __restrict__ b,
                                 const float* __restrict__ f,
                                 float2* __restrict__ baked, int side_f,
                                 HashLevels lv) {
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

extern "C" int pvd_hash_encode2_fwd(const float* x01, const float* table,
                                    float* out, long long n_points,
                                    HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int threads = 256;
  hash_encode2_fwd_kernel<<<(unsigned)n_blocks(n_points, lv, threads),
                            threads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

// K13: g's rows 16-byte aligned (the wrapper checks it), the grid's
// K13_LEVELS levels in order; a block per K13_THREADS points
extern "C" int pvd_hash_encode2_bwd(const float* x01, const float* g,
                                    float* grad_table, long long n_points,
                                    HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  bool ok = lv.n_levels == K13_LEVELS && lv.out_levels == K13_LEVELS;
  // a cell's key c0 + c1 * side must fit an int (the warp pre-sum)
  for (int l = 0; ok && l < K13_LEVELS; ++l)
    ok = lv.level[l] == l && (long long)lv.side[l] * lv.side[l] < (1LL << 31);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_points + K13_THREADS - 1) / K13_THREADS;
  hash_encode2_bwd_kernel<<<(unsigned)blocks, K13_THREADS, 0,
                            (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float4*>(g),
      reinterpret_cast<float2*>(grad_table), n_points, lv);
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

extern "C" int pvd_hash_baked_fwd(const float* x01, const float* baked,
                                  float* out, long long n_points,
                                  HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  if (lv.n_levels > PVD_MAX_BAKED) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  hash_baked_fwd_kernel<<<(unsigned)((n_points + threads - 1) / threads),
                          threads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(baked),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

extern "C" int pvd_hash_bake(const float* table, const int* b, const float* f,
                             float* baked, int side_f, HashLevels lv,
                             void* stream) {
  if (lv.n_levels == 0) return 0;
  const int threads = 256;
  const long long n = (long long)side_f * side_f * side_f * lv.n_levels;
  hash_bake_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(table), b, f,
      reinterpret_cast<float2*>(baked), side_f, lv);
  return (int)cudaGetLastError();
}

// 1 when K11 was built with float4 atomics, 0 with scalar ones.
extern "C" int pvd_hash_cell_vector_atomics() { return PVD_VECTOR_ATOMICS; }
