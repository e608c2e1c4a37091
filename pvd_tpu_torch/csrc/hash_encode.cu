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
// plus the level's offset.  A coordinate outside [0, 1] zeroes all levels;
// a NaN coordinate makes the point's row NaN (its weights are NaN), also
// beside a coordinate outside [0, 1], as the plain version and JAX weight
// by w * okf (the first design wrote zeros there).
// The corner sum accumulates in f32 in corner order, not XLA's order: the
// plain version and the JAX package agree with it to ~1e-7 relative.
//
// A launch covers a list of levels (HashLevels.n_levels entries); entry i
// writes level slot level[i] of a row of out_levels slots, so the corner
// levels (K1) and the cell levels (K10) fill one [N, L * 2] output.  K1's
// entries are a run of consecutive slots (the entry checks it).
//
// Bound on the H100: memory by the byte count (the touched rows once, the
// output once), but what holds the kernel is the cost of each (point,
// level): a lattice, 8 scattered 8-byte rows (each its own 32-byte sector)
// and 16 FMAs.  The first design ran one thread per (point, level), level
// fastest: a 64-bit division a thread, the level constants read with a
// per-lane index, both row formulas for every lane; without its table
// loads it kept most of its time at the exact teacher's 131,072 points, so
// instructions, not rows, held it.  The design now, above 8 levels
// (hash_encode_fwd_kernel): a block of K1_POINTS consecutive points of the
// ray-major stream times level groups of K1_PER levels (a thread a point
// and a group; a warp holds one group, so the level constants and the
// hashed-or-dense choice are uniform across it; past K1_SPAN levels a
// second block takes the rest); k1_level forms a level's lattice with no
// floorf or float-to-int conversion and its rows from 6 per-axis terms; a
// thread issues all its levels' loads before any corner sum; the block
// stages its rows in shared memory and writes them as consecutive
// float2s.  On the H100 (PERF.md §6) against the first design: 0.55x at
// the padded warm-up's 786,432 points (a ray's empty slots repeat one
// point, so a warp's loads coalesce), 0.86x at the teacher's 131,072,
// 0.82x at the serving chunk, 0.91x at the sweep, still ~3.6x the byte
// bound at the batches.  Up to 8 levels (the cell teacher's 5) the first
// design runs (hash_encode_fwd_per_level_kernel): there it beat this body
// at 1 level a thread by ~0.7% in ten rotated rounds, and at 2 by more.
// Measured and dropped: a thread walking all of a point's levels (few
// loads in flight), a level-major grid (blockIdx.y the level, to keep one
// level's rows hot in the L2; its strided stores lost more), 16-byte
// loads of x-neighbour row pairs and the first design with the lean
// lattice (no gain), rows written from registers as float4 level pairs,
// 4 levels a thread, a thread looping over level groups (more registers:
// half the blocks an SM, 1.35-1.67x slower).
//
// K7: the table gradient, replacing pvd_tpu/ops/hashgrid.py:284
// _corner_gather_sum_bwd (hashed levels) and the autodiff of the packed
// dense gather (build_packed_dense, :420) for the dense levels:
//   g_table[offset_l + row(corner k)] += w_k * g[n, l]
// over the same 8 corners, rows and weights as K1 (the shared
// corner_setup below).  No gradient reaches x01: sample positions come from
// the march, so the JAX package's g_w term has no consumer here.
// Bound on the H100: memory, the wrapper's zeroed dense gradient (42 MB at
// the INGP width, 4.7 MB in cell mode, where K7 covers the dense corner
// levels 0-4 only) plus 12 B of x01 and the point's row of g read once;
// every add lands on a table that sits in the 50 MB L2.  What limits the
// kernel is how many atomics the L2 must serialize on one address: the
// coarse levels have few rows (17^3 at level 0), and a training batch puts
// ~135 adds on each of them.  The first design ran one thread per (point,
// level) with 16 scalar atomics each (lanes of a warp on different levels
// of ~2 points could never pool them): 17x its bound at the exact
// teacher's 131,072 compacted points.
// The design now (hash_encode_bwd_kernel, K13's at D = 3): one thread per
// point, a block per 128 consecutive points of the ray-major stream, so
// neighbouring lanes hold neighbouring samples of a few rays and share
// coarse cells.  It reads x01 once and its row of g a level pair at a time
// (float4s, the next pair in flight while this one adds).  The level loop
// is unrolled to compile-time indices of the by-value list.  At each level
// the lanes whose points fall in one lattice cell (one 64-bit key of the
// base coordinates: corner 0's hashed row is no key, two cells can share
// it and differ at other corners) sum their 16 contributions in registers
// (peer_sum), and the lowest of them adds, one float2 atomic per corner;
// points outside the cube or with a NaN coordinate add nothing.
// A warp with nothing to add at a level (the padded stream's zero rows, a
// g of (0, 0) there) skips it.  The pre-sum runs at the hashed levels too:
// there peers are rarer, but a dense-only pre-sum measured 20% slower at
// the exact teacher's shape (PERF.md).  Each product w_k * g is rounded
// as before; only the order of the sums changes (it varies from run to
// run), so the card check uses a relative tolerance.
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
// loads and writes one float2; a NaN coordinate gives NaN there, also
// beside one outside [0, 1] (K1's rule: JAX weights by w * okf), and a
// point outside gives 0.  Bound: memory, one 64-byte row per pair (two
// 32-byte sectors, all useful) against K1's eight scattered 8-byte rows;
// the 37.7 MB cell table fits the L2.
//
// K11: the cell table's gradient, replacing _cell_gather_sum_bwd (:362),
// the table part (no g_w, as in K7): row[2k : 2k+2] += w_k * g[n, l].
// Bound: memory, the wrapper's dense 37.7 MB zeroed gradient (AdamW
// updates every row, as optax does) plus one 64-byte read-modify-write per
// active pair.  On the H100 the fill alone takes 0.016 ms (2.3 TB/s), more
// than the first design's kernel at the A/B teacher's batch (0.014 ms,
// PERF.md §6).  That design ran one thread per (point, cell level), level
// fastest, adding four float4 atomics per active pair: a warp held ~3.5
// points at 9 levels, so no two lanes could pool an add, though a ray's
// consecutive samples share the coarse cells (level 5 is ~100 cells a
// side, about six march steps per cell).
// The design now (hash_cell_bwd_kernel): a block per 32 consecutive points
// of the ray-major stream and a warp per cell level, so the level
// constants are warp-uniform and a warp's lanes are consecutive samples at
// one level.  The block first counts its live (point, level) pairs.  A
// sparse block (at most half its lanes live: the padded warm-up, a ray's
// few samples among 96 slots) packs them into its first warps, a thread per
// pair adding its row as four float4s, as the first design did.  A dense
// block (the compacted stream) pre-sums at every level: the lanes of a
// lattice cell sum their 16 products in registers (K7's peer_sum and
// 64-bit cell key), and the leaders' rows are staged in shared memory and
// added four lanes a row, one warp instruction adding 8 whole rows.
// Measured on the H100 and dropped (PERF.md §6): a thread per point
// walking all 9 levels (65,536 threads underfill the card), the leader
// adding its row alone (slower than four lanes at the compacted stream),
// staging only above 8 leaders (no gain), the block's g rows and x01 read
// into shared memory first (slower padded), and no sparse path (slower
// than the first design padded).  Each product
// w_k * g is rounded as before; only the order of the sums changes (it
// varies from run to run), so the card check uses a relative tolerance.  A
// point with a NaN coordinate adds nothing: in JAX and the plain version
// its row comes from an undefined float-to-int cast (ROADMAP C).

// K12: the D = 2 encode, replacing pvd_tpu/ops/hashgrid.py:533 hash_encode
// at input_dim 2 as pvd_tpu/models/api.py:127 background_rgb calls it: the
// polar coordinates of the background sphere, (polar + 1) / 2 in [0, 1]^2,
// on bg_grid_spec's 4 levels x 2 channels (resolutions 16/81/407/2048:
// levels 0-2 dense and row-major, c0 + c1 * side; level 3 hashed,
// (c0 * 1 ^ c1 * 2654435761) & (2^19 - 1)), a 697,776 x 2 table (5.6 MB).
// It is K1's first design's body at D = 2: the same x01 * scale + 0.5 FMA,
// bilinear weights over 4 corners and one thread per (point, level);
// inputs outside [0, 1]^2 give 0, a NaN coordinate NaN (K1's rule).  Bound on the H100: memory, 4 rows of
// 8 B per (point, level) from a table that fits the L2, 8 B read and 32 B
// written per point; one launch per composited batch, on N rays, not on
// the samples, so it is small beside K1.
//
// K13: its table gradient, g_table[offset_l + row(corner k)] += w_k * g[n, l]
// into a zeroed dense [697,776, 2] gradient, with K12's corner rows and
// weights (corner_setup, corner_weight: the x01 * scale + 0.5 FMA) and the
// products w_k * g rounded as K7 rounds them; pairs with g = (0, 0),
// points outside the square and NaN points add nothing.  Bound on the H100: memory, the
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
// tolerance.
//
// K15: the baked dense levels' encode, replacing the baked branch of
// pvd_tpu/ops/hashgrid.py:533 hash_encode (:584-590, :635-646) for a frozen
// table.  The bake (K16) stores at every vertex of the finest dense level's
// lattice (side_f per axis) the features of all Ld dense levels, one row of
// Ld * 2 floats.  Per point: the finest dense level's base cell and 8
// trilinear weights exactly as K1 forms them (corner_setup, corner_weight:
// the x01 * scale + 0.5 FMA, zeros outside [0, 1]^3, NaN for a NaN
// coordinate as in K1), then the 8 corner
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
#include <math_constants.h>
#include <stdint.h>

#define PVD_MAX_LEVELS 32
#define PVD_MAX_BAKED 8
#define K13_LEVELS 4  // the background grid's (bg_grid_spec)
#define K13_THREADS 128
#define K7_THREADS 128
#define K11_SPAN 16  // cell levels a K11 block (a warp each)
#define K1_POINTS 64  // points a K1 block
#define K1_PER 2  // levels a K1 thread
#define K1_MAX_THREADS 512  // 8 level groups of K1_POINTS threads
#define K1_SPAN (K1_MAX_THREADS / K1_POINTS * K1_PER)  // levels a K1 block

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

template <int D>
__device__ __forceinline__ bool has_nan(const float (&x)[D]) {
  bool n = false;
#pragma unroll
  for (int d = 0; d < D; ++d) n = n || isnan(x[d]);
  return n;
}

// Not inside [0, 1] in some dimension: hashgrid.py:571's (x < 0) | (x > 1),
// or a NaN coordinate.  The encodes test has_nan first (a NaN point's row
// is NaN, as in JAX); the table gradients drop a NaN point with the points
// outside: its lattice comes from an undefined float-to-int cast, in JAX as
// in the plain version, so no row of its gradient is defined.
template <int D>
__device__ __forceinline__ bool outside(const float (&x)[D]) {
  bool o = false;
#pragma unroll
  for (int d = 0; d < D; ++d) o = o || !(x[d] >= 0.f && x[d] <= 1.f);
  return o;
}

// The encodes' rule for a point that is NaN or outside: true when it gives
// *o, NaN for a NaN coordinate (also beside one outside [0, 1]: the plain
// version and JAX weight by w * okf) and 0 outside.
template <int D>
__device__ __forceinline__ bool nan_or_outside(const float (&x)[D],
                                               float& z) {
  z = has_nan<D>(x) ? CUDART_NAN_F : 0.f;
  return outside<D>(x);
}

// K12, and K1 on at most 8 levels: one thread per (point, level entry),
// level fastest (K1's first design).
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
  float z;
  if (nan_or_outside<D>(x, z)) {
    *o = make_float2(z, z);
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

// K1: the lattice of one level of the point at x (inside [0, 1]^3): the
// same base, fractions, rows and weights as corner_setup / corner_row /
// corner_weight, in fewer integer and conversion instructions.  pos = x * s
// + 0.5 lies in [0.5, 2^23), so pos + 2^23 rounded down is exactly
// floor(pos) + 2^23: its mantissa bits are the base coordinate (no floorf,
// no float-to-int conversion), and subtracting 2^23 again gives floor(pos)
// exactly.  The 8 rows come from 6 per-axis terms (corner k adds 1 along x,
// side or the y prime along y, side^2 or the z prime along z: (c + 1) * P
// = c * P + P mod 2^32, and the hash mask distributes over the xor).  The
// weight of corner k is (wx * wy) * wz, corner_weight's products.
struct K1Level {
  uint32_t row[8];
  float w[8];
};

__device__ __forceinline__ void k1_level(const float (&x)[3], int i,
                                         const HashLevels& lv, K1Level& e) {
  const float s = lv.scale[i];
  float f[3], g[3];
  uint32_t c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmaf_rn(x[d], s, 0.5f);
    const float r = __fadd_rd(pos, 8388608.f);
    f[d] = __fsub_rn(pos, __fsub_rn(r, 8388608.f));
    g[d] = __fsub_rn(1.f, f[d]);
    c[d] = __float_as_uint(r) & 0x7fffffu;
  }
  uint32_t ax[2], ay[2], az[2];
  if (lv.hashed[i]) {
    const uint32_t m = lv.hash_mask;
    const uint32_t hy = c[1] * 2654435761u, hz = c[2] * 805459861u;
    ax[0] = c[0] & m;
    ax[1] = (c[0] + 1u) & m;
    ay[0] = hy & m;
    ay[1] = (hy + 2654435761u) & m;
    az[0] = hz & m;
    az[1] = (hz + 805459861u) & m;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e.row[k] = ax[k & 1] ^ ay[(k >> 1) & 1] ^ az[k >> 2];
  } else {
    const uint32_t side = (uint32_t)lv.side[i], side2 = side * side;
    ax[0] = c[0];
    ax[1] = c[0] + 1u;
    ay[0] = c[1] * side;
    ay[1] = ay[0] + side;
    az[0] = c[2] * side2;
    az[1] = az[0] + side2;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e.row[k] = ax[k & 1] + ay[(k >> 1) & 1] + az[k >> 2];
  }
  const float wxy[4] = {__fmul_rn(g[0], g[1]), __fmul_rn(f[0], g[1]),
                        __fmul_rn(g[0], f[1]), __fmul_rn(f[0], f[1])};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    e.w[k] = __fmul_rn(wxy[k & 3], (k & 4) ? f[2] : g[2]);
}

// K1: a block of K1_POINTS consecutive points of the ray-major stream
// (lane p) times level groups (g = threadIdx.x / K1_POINTS, warp-uniform)
// of K1_PER consecutive entries, so every level constant and the
// hashed-or-dense choice are uniform across a warp.  A block holds up to
// K1_SPAN levels; blockIdx.y picks its run of them (more than one only
// past K1_SPAN levels).  A thread forms the rows of its group's levels,
// issues all their 8 * K1_PER loads, then sums each level's corners in
// corner order with FMAs into the block's shared tile (rows of m | 1
// float2s for the block's m levels: odd, so a half-warp's 16 rows fall in
// 16 bank pairs); then the block writes its rows' slots (the entries are
// consecutive slots: the entry checks it) as consecutive float2s.
__global__ void __launch_bounds__(K1_MAX_THREADS)
    hash_encode_fwd_kernel(const float* __restrict__ x01,
                           const float2* __restrict__ table,
                           float2* __restrict__ out, long long n_points,
                           HashLevels lv) {
  extern __shared__ float2 k1_tile[];
  const int lo = blockIdx.y * K1_SPAN;
  const int m = min(lv.n_levels - lo, K1_SPAN), st = m | 1;
  const int p = threadIdx.x % K1_POINTS;
  const int c = threadIdx.x / K1_POINTS * K1_PER, i0 = lo + c;  // entries
  float2* tile = k1_tile + p * st + c;  // the thread's slots of its row
  const long long n0 = (long long)blockIdx.x * K1_POINTS;
  if (n0 + p < n_points) {
    float x[3];
    load_point<3>(x01, n0 + p, x);
    float z;
    if (nan_or_outside<3>(x, z)) {
#pragma unroll
      for (int j = 0; j < K1_PER; ++j)
        if (c + j < m) tile[j] = make_float2(z, z);
    } else {
      K1Level e[K1_PER];
      float2 v[K1_PER][8];
#pragma unroll
      for (int j = 0; j < K1_PER; ++j)
        if (c + j < m) k1_level(x, i0 + j, lv, e[j]);
#pragma unroll
      for (int j = 0; j < K1_PER; ++j)
        if (c + j < m) {
          const float2* tl = table + lv.offset[i0 + j];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[j][k] = __ldg(tl + e[j].row[k]);
        }
#pragma unroll
      for (int j = 0; j < K1_PER; ++j)
        if (c + j < m) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            a0 = __fmaf_rn(e[j].w[k], v[j][k].x, a0);
            a1 = __fmaf_rn(e[j].w[k], v[j][k].y, a1);
          }
          tile[j] = make_float2(a0, a1);
        }
    }
  }
  __syncthreads();
  // element e of the block's rows x m slots: row e / m, as the high word
  // of e * ceil(2^32 / m) (exact for e < 2^16, 1 < m <= 32)
  const int rows = (int)min((long long)K1_POINTS, n_points - n0);
  const uint32_t inv = m > 1 ? 0xffffffffu / (uint32_t)m + 1u : 0u;
  float2* o = out + n0 * lv.out_levels + lv.level[0] + lo;
  for (uint32_t e = threadIdx.x; e < (uint32_t)(rows * m); e += blockDim.x) {
    const uint32_t r = m > 1 ? __umulhi(e, inv) : e, i = e - r * m;
    o[(long long)r * lv.out_levels + i] = k1_tile[r * st + i];
  }
}

__global__ void hash_encode_fwd_per_level_kernel(
    const float* __restrict__ x01, const float2* __restrict__ table,
    float2* __restrict__ out, long long n_points, HashLevels lv) {
  encode_fwd<3>(x01, table, out, n_points, lv);
}

__global__ void hash_encode2_fwd_kernel(const float* __restrict__ x01,
                                        const float2* __restrict__ table,
                                        float2* __restrict__ out,
                                        long long n_points, HashLevels lv) {
  encode_fwd<2>(x01, table, out, n_points, lv);
}

// K7, K13: float2 atomic add into a global gradient row
__device__ __forceinline__ void add_row(float2* dst, float a, float b) {
#if PVD_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

// K11: float4 atomic add into a global gradient row quarter
__device__ __forceinline__ void add_quad(float4* dst, float4 v) {
#if PVD_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, v);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

// K7, K11, K13: per value v[j], the sum over the lanes of `peers` (the lanes whose
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

// K7: level entry l (a compile-time index once the caller's loop is
// unrolled) of one point with upstream (gx, gy).  The key of a lattice cell
// is its base coordinates, 21 bits each (the entry checks side < 2^21); a
// lane that adds nothing takes a key of its own (bit 63 and its lane), so it
// joins no group and adds no round to peer_sum.
__device__ __forceinline__ void k7_level(const float (&x)[3], bool in,
                                         float gx, float gy, int l,
                                         const HashLevels& lv,
                                         float2* __restrict__ grad) {
  const int lane = threadIdx.x & 31;
  const bool add = in && (gx != 0.f || gy != 0.f);
  if (!__any_sync(0xffffffffu, add)) return;
  const Corners<3> c = corner_setup<3>(x, l, lv);
  float v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight<3>(c, k);
    v[2 * k] = add ? __fmul_rn(w, gx) : 0.f;
    v[2 * k + 1] = add ? __fmul_rn(w, gy) : 0.f;
  }
  const unsigned long long key =
      add ? ((unsigned long long)c.i[0] | ((unsigned long long)c.i[1] << 21) |
             ((unsigned long long)c.i[2] << 42))
          : ((1ull << 63) | (unsigned long long)lane);
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  peer_sum<16>(peers, v);
  if (!add || __ffs(peers) - 1 != lane) return;
  float2* gl = grad + lv.offset[l];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    add_row(gl + corner_row<3>(c, k, lv.hash_mask), v[2 * k], v[2 * k + 1]);
}

// K7: one thread per point; the launch's entries are level slots 0..n-1 of
// each upstream row (the corner levels are a prefix of the levels; the
// entry checks it).  Rows are read a level pair at a time, as float4s when
// the row has an even number of slots (16-byte aligned: the wrapper checks
// g) and as float2s when it has not.  A lane past the end or outside the
// cube adds nothing but runs the warp votes.
__global__ void __launch_bounds__(K7_THREADS)
    hash_encode_bwd_kernel(const float* __restrict__ x01,
                           const float* __restrict__ g,
                           float2* __restrict__ grad, long long n_points,
                           HashLevels lv) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < n_points;
  const int nl = lv.n_levels;
  const bool vec = (lv.out_levels & 1) == 0;
  const float* row = g + 2 * (long long)lv.out_levels * (live ? n : 0);
  auto pair = [&](int l) {  // slots l and l + 1 (zeros past the entries)
    if (!live) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) return __ldg(reinterpret_cast<const float4*>(row + 2 * l));
    const float2 a = __ldg(reinterpret_cast<const float2*>(row + 2 * l));
    const float2 b =
        l + 1 < nl ? __ldg(reinterpret_cast<const float2*>(row + 2 * l + 2))
                   : make_float2(0.f, 0.f);
    return make_float4(a.x, a.y, b.x, b.y);
  };
  float4 cur = pair(0);
  float x[3] = {0.f, 0.f, 0.f};
  if (live) load_point<3>(x01, n, x);
  const bool in = live && !outside<3>(x);
#pragma unroll
  for (int l = 0; l < PVD_MAX_LEVELS; l += 2) {
    if (l >= nl) break;
    const float4 next =
        l + 2 < nl ? pair(l + 2) : make_float4(0.f, 0.f, 0.f, 0.f);
    k7_level(x, in, cur.x, cur.y, l, lv, grad);
    if (l + 1 < nl) k7_level(x, in, cur.z, cur.w, l + 1, lv, grad);
    cur = next;
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
  float x[3], z;
  load_point<3>(x01, n, x);
  if (nan_or_outside<3>(x, z)) {
    *o = make_float2(z, z);
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

// K11, a dense block: cell level entry l (warp-uniform) of the warp's
// points, `add` where a point is inside the cube and its upstream (gx, gy)
// is not zero.  The lanes in one lattice cell (K7's 64-bit key of the base
// coordinates: the hashed row is no key, two cells can share it) sum their
// 16 products in registers (peer_sum); each group's lowest lane, a leader,
// stages its row in the warp's slice of shared memory, in ballot order,
// and lane i adds quarter i % 4 of staged row i / 4, so one warp
// instruction adds 8 whole 64-byte rows.
__device__ __forceinline__ void k11_level(const float (&x)[3], bool add,
                                          float2 gv, int l,
                                          const HashLevels& lv,
                                          float4* __restrict__ grad,
                                          float4 (*stage)[4],
                                          long long* stage_row) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(0xffffffffu, add)) return;
  const Corners<3> c = corner_setup<3>(x, l, lv);
  float v[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight<3>(c, k);
    v[2 * k] = add ? __fmul_rn(w, gv.x) : 0.f;
    v[2 * k + 1] = add ? __fmul_rn(w, gv.y) : 0.f;
  }
  const unsigned long long key =
      add ? ((unsigned long long)c.i[0] | ((unsigned long long)c.i[1] << 21) |
             ((unsigned long long)c.i[2] << 42))
          : ((1ull << 63) | (unsigned long long)lane);
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  peer_sum<16>(peers, v);
  const bool lead = add && __ffs(peers) - 1 == lane;
  const unsigned leads = __ballot_sync(0xffffffffu, lead);
  if (lead) {
    const int slot = __popc(leads & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stage[slot][q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                   v[4 * q + 3]);
    stage_row[slot] = cell_row(c, l, lv);
  }
  __syncwarp();
  for (int i = lane; i < 4 * __popc(leads); i += 32)
    add_quad(grad + 4 * stage_row[i >> 2] + (i & 3), stage[i >> 2][i & 3]);
}

// Position of the k-th set bit (from 0) of mask, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned mask, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int low = __popc(mask & ((1u << half) - 1u));
    if (k >= low) {
      k -= low;
      mask >>= half;
      pos += half;
    }
  }
  return pos;
}

// K11: a block per 32 consecutive points of the ray-major stream and up to
// K11_SPAN cell level entries (blockIdx.y takes the rest), a warp per
// entry: the level constants are warp-uniform.  A lane outside the cube,
// with a NaN coordinate or with g = (0, 0) adds nothing.  The block counts
// its live (point, level) pairs first: at most half of its level entries'
// lanes (the padded warm-up's stream, a ray's few samples in 96 slots) and
// a thread per live pair, packed into the block's first warps, adds its
// row as four float4s; more (the compacted stream) and each warp pre-sums
// its lanes by lattice cell (k11_level).
__global__ void __launch_bounds__(32 * K11_SPAN)
    hash_cell_bwd_kernel(const float* __restrict__ x01,
                         const float2* __restrict__ g,
                         float4* __restrict__ grad, long long n_points,
                         HashLevels lv) {
  // each warp's live lanes and upstream values; then its staged rows
  // ([warps][32][4] float4s, then [warps][32] row indices)
  __shared__ unsigned live_s[K11_SPAN];
  __shared__ float2 g_s[K11_SPAN][32];
  extern __shared__ float4 k11_stage[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e0 = blockIdx.y * K11_SPAN, l = e0 + warp;
  const long long n0 = (long long)blockIdx.x * 32, n = n0 + lane;
  const bool live = n < n_points && l < lv.n_levels;
  const float2 gv = live ? __ldg(g + (long long)lv.out_levels * n +
                                  lv.level[l])
                         : make_float2(0.f, 0.f);
  float x[3] = {0.f, 0.f, 0.f};
  bool add = gv.x != 0.f || gv.y != 0.f;
  if (add) {
    load_point<3>(x01, n, x);
    add = !outside<3>(x);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, add);
  if (lane == 0) live_s[warp] = mask;
  g_s[warp][lane] = gv;
  __syncthreads();
  // the block's level entries (fewer than its warps in a last blockIdx.y)
  const int m = min(lv.n_levels - e0, warps);
  int total = 0;
  for (int w = 0; w < m; ++w) total += __popc(live_s[w]);
  if (2 * total <= 32 * m) {
    int t = threadIdx.x, w = 0;
    if (t >= total) return;
    while (t >= __popc(live_s[w])) t -= __popc(live_s[w++]);
    const int p = nth_bit(live_s[w], t), le = e0 + w;
    float xp[3];
    load_point<3>(x01, n0 + p, xp);
    const float2 gp = g_s[w][p];
    const Corners<3> c = corner_setup<3>(xp, le, lv);
    float4* dst = grad + 4 * cell_row(c, le, lv);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float w0 = corner_weight<3>(c, 2 * q);
      const float w1 = corner_weight<3>(c, 2 * q + 1);
      add_quad(dst + q, make_float4(__fmul_rn(w0, gp.x), __fmul_rn(w0, gp.y),
                                    __fmul_rn(w1, gp.x),
                                    __fmul_rn(w1, gp.y)));
    }
    return;
  }
  if (l >= lv.n_levels) return;  // the whole warp
  k11_level(x, add, gv, l, lv, grad,
            reinterpret_cast<float4(*)[4]>(k11_stage) + 32 * warp,
            reinterpret_cast<long long*>(k11_stage + 128 * warps) +
                32 * warp);
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
  float x[3], z;
  load_point<3>(x01, n, x);
  if (nan_or_outside<3>(x, z)) {
#pragma unroll
    for (int j = 0; j < PVD_MAX_BAKED; ++j)
      if (j < ld) o[lv.level[j]] = make_float2(z, z);
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

// K1: the entries are consecutive level slots (the corner levels, or the
// hashed ones a baked encode leaves).
extern "C" int pvd_hash_encode_fwd(const float* x01, const float* table,
                                   float* out, long long n_points,
                                   HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int nl = lv.n_levels;
  bool ok = nl <= PVD_MAX_LEVELS && lv.level[0] + nl <= lv.out_levels;
  // k1_level's floor needs pos = x * scale + 0.5 under 2^23
  for (int l = 0; ok && l < nl; ++l)
    ok = lv.level[l] == lv.level[0] + l && lv.scale[l] < 4194304.f;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* t = reinterpret_cast<const float2*>(table);
  float2* o = reinterpret_cast<float2*>(out);
  if (nl <= 8) {  // the first design: faster at the cell teacher's 5 levels
    hash_encode_fwd_per_level_kernel<<<(unsigned)n_blocks(n_points, lv, 256),
                                       256, 0, s>>>(x01, t, o, n_points, lv);
    return (int)cudaGetLastError();
  }
  const int m = nl < K1_SPAN ? nl : K1_SPAN;  // a block's levels
  const int threads = K1_POINTS * ((m + K1_PER - 1) / K1_PER);
  const size_t smem = (size_t)K1_POINTS * (m | 1) * sizeof(float2);
  const dim3 blocks((unsigned)((n_points + K1_POINTS - 1) / K1_POINTS),
                    (unsigned)((nl + K1_SPAN - 1) / K1_SPAN));
  hash_encode_fwd_kernel<<<blocks, threads, smem, s>>>(x01, t, o, n_points,
                                                       lv);
  return (int)cudaGetLastError();
}

// K7: the entries are level slots 0..n-1 (the corner levels), each lattice
// side under 2^21 (the cell key); g's rows 16-byte aligned when they have an
// even number of slots (the wrapper checks it); a block per K7_THREADS points
extern "C" int pvd_hash_encode_bwd(const float* x01, const float* g,
                                   float* grad_table, long long n_points,
                                   HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  bool ok = lv.n_levels <= lv.out_levels && lv.n_levels <= PVD_MAX_LEVELS &&
            (lv.out_levels % 2 || (uintptr_t)g % 16 == 0);
  for (int l = 0; ok && l < lv.n_levels; ++l)
    ok = lv.level[l] == l && lv.side[l] < (1 << 21);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_points + K7_THREADS - 1) / K7_THREADS;
  hash_encode_bwd_kernel<<<(unsigned)blocks, K7_THREADS, 0,
                           (cudaStream_t)stream>>>(
      x01, g, reinterpret_cast<float2*>(grad_table), n_points, lv);
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

// K11: the entries in increasing slots of a row, each lattice side under
// 2^21 (the cell key); g 8-byte aligned (the wrapper checks it)
extern "C" int pvd_hash_cell_bwd(const float* x01, const float* g,
                                 float* grad_cell, long long n_points,
                                 HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  bool ok = lv.n_levels <= PVD_MAX_LEVELS && (uintptr_t)g % 8 == 0;
  for (int l = 0; ok && l < lv.n_levels; ++l)
    ok = lv.level[l] >= (l ? lv.level[l - 1] + 1 : 0) &&
         lv.level[l] < lv.out_levels && lv.side[l] < (1 << 21);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int span = lv.n_levels < K11_SPAN ? lv.n_levels : K11_SPAN;
  const dim3 blocks((unsigned)((n_points + 31) / 32),
                    (unsigned)((lv.n_levels + K11_SPAN - 1) / K11_SPAN));
  hash_cell_bwd_kernel<<<blocks, 32 * span,
                         span * 32 * (4 * sizeof(float4) + sizeof(long long)),
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
