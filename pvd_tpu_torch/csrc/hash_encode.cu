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
// bit; a NaN coordinate gives NaN there, also beside one outside [0, 1]
// (K1's rule: JAX weights by w * okf), and a point outside gives 0.
// Bound: memory, one 64-byte row per pair (two 32-byte sectors, all
// useful) against K1's eight scattered 8-byte rows.  The 37.7 MB cell
// table fits the L2, so the byte bound (the touched rows once, the output
// once) is far under what the pairs pull from the L2: 64 B each, 37.7 MB
// at the A/B teacher's 65,536 x 9.
// The first design ran one thread per (point, cell level), level fastest:
// a warp held ~3.5 points at 9 levels, read the level constants with a
// per-lane index and stored one float2 a thread at a 112-byte stride.
// The design now (hash_cell_fwd_kernel): K11's block shape, a block per 32
// consecutive points and a warp per cell level, so the level constants
// are warp-uniform and a warp's lanes are consecutive samples at one
// level; each lane loads its row as four float4s, and the block stages
// its results in shared memory and writes each point's run of cell slots
// with consecutive lanes.  On the H100 80GB HBM3 at 700 W (PERF.md §6)
// the kernel alone takes 0.0094-0.0095 ms against the first design's
// 0.0116-0.0117 at the A/B teacher's batch and 0.042 against 0.053 in
// the padded warm-up: the level constants were not what held it; the L2
// traffic of its rows is (37.7 MB a call there, ~4 TB/s).
// Measured and dropped (throwaway builds beside the parent's K10, so no
// figures): four lanes a row (one float4 each and a shuffle sum, 8 whole
// rows a warp instruction: slower at every shape), two points a lane
// (slower), x01 staged in shared memory and K1's lattice without floorf
// (no gain), and each lane storing its float2 straight into an 8-byte
// aligned out instead of the staged runs (slower at every shape: a
// warp's 32 stores then fall in 32 rows 112 bytes apart).
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
// The same x01 * scale + 0.5 FMA and bilinear weights over 4 corners as
// K1; inputs outside [0, 1]^2 give 0, a NaN coordinate NaN (K1's rule).
// Bound on the H100: memory, 4 rows of 8 B per (point, level) from a table
// that fits the L2, 8 B read and 32 B written per point: 0.1 us at the
// 4,096 rays every path sends it (a training batch, an eval chunk), far
// below any launch, so what holds it is one thread's latency: its x01
// load, its rows' loads, its store.
// The design is the first one, K1's first design's body at D = 2
// (encode_fwd<2>): one thread per (point, level), level fastest, blocks of
// 256, so a warp's stores are 256 consecutive bytes and a thread waits on
// two loads in turn, the shortest chain any design has.  Timed against it
// in ten rotated rounds on the H100 80GB HBM3 at 700 W (the kernel alone,
// at 4,096 polar points / 262,144; tools/torch_k12_k15_rounds.py, the
// designs in tools/k12_k15_candidates.cu; PERF.md §6):
//   this design                                      0.00187 / 0.00825 ms
//   (a) K1's redesigned body: a thread per point and pair of levels, the
//       lattice without float-to-int, its 8 loads issued together, rows
//       staged in shared memory and written as 32-byte runs
//                                                    0.00196 / 0.00613
//   (b) a thread per point over the 4 levels: x01 as one float2, 16 loads
//       in flight, the row stored as two float4s, 32 / 64 / 128 a block
//                                0.00234 / 0.00230 / 0.00242, 0.0081-0.0086
//   (c) this design in blocks of 64                  0.00193 / 0.01150
//   (d) this design without its 64-bit division and runtime-indexed level
//       constants, with (a)'s lattice, 256 / 128 a block
//                                          0.00189 / 0.00195, 0.0079-0.0081
// At 4,096 points every other design lengthens a thread's chain (a's
// barrier and shared-memory round trip, b's 16 loads a thread over 4,096
// threads) or adds blocks; (a) wins only at a whole view's 262,144 points,
// which no path sends, so it is not built.
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
// Ld * 2 floats (40 B at Ld 5, 8-byte aligned).  Per point: the finest
// dense level's base cell and 8 trilinear weights exactly as K1 forms them
// (corner_setup, corner_weight: the x01 * scale + 0.5 FMA, zeros outside
// [0, 1]^3, NaN for a NaN coordinate as in K1), then the 8 corner rows
// c0 + c1 * side_f + c2 * side_f^2 of the vertex table, and for each dense
// level j the weighted corner sum of its 2 floats (FMAs over corners 0..7
// in order, not XLA's 0/1 matmul order) into level slot level[0] + j of
// the [N, L * 2] output that K1 (the other corner levels) and K10 (the
// cell levels) fill too.  A point inside the cube never reaches past the
// far faces (base <= side_f - 2), where the JAX package's packed rows hold
// zeros.  The TPU packs the 8 neighbours into one row for its row-rate-
// bound gather engine; here the vertex rows are read directly.
// Bound on the H100: memory.  12 B of x01 in and Ld * 8 B out per point,
// and the touched vertex rows once (the table, 15.6 MB at side 73, Ld 5,
// fits the 50 MB L2).  What held the first design (one thread per point:
// 40 scalar 8-byte loads, 8 corner rows x 5 levels, then 5 stores at the
// output's 112-byte row stride; 96 blocks at the CLI step's 24,576
// points, under one wave) was the L2's sector traffic: at scattered points
// each of a warp's load instructions touched 32 sectors, ~1,280 B a point
// for its 320 B of rows.
// The design now (hash_baked_fwd_kernel): a thread per (point, dense
// level), level fastest, a block of (Ld, K15_POINTS) threads; a point's Ld
// lanes read each corner row as consecutive 8-byte pieces, so one warp
// instruction touches ~2 sectors a point, and write the point's slots as
// one 40-byte run.  Each lane forms the lattice and runs the FMA chain as
// the first design did, so every slot is its bit for bit.  In ten rotated
// rounds on the H100 80GB HBM3 at 700 W (the kernel alone; at 24,576 and
// 65,536 ray-ordered points, 131,072 and 2,097,152 uniform ones;
// tools/torch_k12_k15_rounds.py; PERF.md §6):
//   this design, 64 points a block        0.00250 / 0.00383 / 0.0129 / 0.2025
//   the first design                      0.00448 / 0.00751 / 0.0494 / 0.8024
//   (a) (point, corner) lanes: 8 lanes a point, lane pairs reading the
//       80-byte run of rows x, x + 1 as consecutive float2s, rows and
//       weights staged in shared memory, then (point, level) lanes, 32 / 64
//       points a block                    0.00363 / 0.00667 / 0.0169 / 0.2434
//                                         0.00366 / 0.00703 / 0.0175 / 0.2500
//   this design at 32 / 128 points a block: within 3% of 64 everywhere.
// (a) loads the fewest sectors, but runs 8 lanes a point through a barrier
// and a shared-memory round trip; the level lanes' loads of corners x and
// x + 1 (adjacent rows) share their sectors through the L1.  At an eval
// chunk's 393,216 slots (12,394 vertex rows touched) F.grid_sample, which
// writes its own contiguous [10, N] output, beats it (PERF.md §6, §7: the
// 40-byte runs at a 112-byte stride write two partly filled sectors each).
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
// Runs once per load_teacher.  Bound on the H100: memory, every dense
// level's rows read once (1.57 MB of coarse tables and 3.11 MB of the
// finest at bound 1's side 73, 5 levels) and the vertex table written once
// (15.56 MB): 6.0 us.  The first design ran one thread per (fine vertex,
// level), level fastest, over a flat grid: a 64-bit division and
// remainder a thread, the level constants read with a runtime index, and
// in one warp the finest level's copying lanes beside coarse lanes
// gathering from four tables: 0.022-0.024 ms alone at bound 1, 4x its
// bound.  The design now (hash_bake_kernel): a block per fine row (y, z),
// K16_THREADS lanes running along x within a level, so adjacent lanes
// gather adjacent rows of one coarse table; the row-uniform y and z terms
// set out once a block, the constants read by compile-time index; the
// row's Ld * side_f float2s staged in shared memory and stored as one
// contiguous run (2,920 B at side 73).  On the H100 80GB HBM3 at 700 W
// (PERF.md §6, the kernel alone, in turns with the first design) 0.0145-
// 0.0150 ms at bound 1 against 0.0223-0.0244, 0.0082 at bound 2 (side 59,
// 4 levels) against 0.0113-0.0114: 2.4x and 3.1x the bound.  Measured
// and dropped, in six rotated rounds on random tables
// (tools/torch_k8_k16_rounds.py; this design 0.01436 / 0.00817 ms at
// bound 1 / 2, the first 0.02426 / 0.01125):
//   (b) the first design's mapping on a 3-D grid (no division), (Ld, 32)
//       or (Ld, 64) a block                   0.02051-0.02203 / 0.00927-0.00934
//   this design at 64 / 256 threads a block   0.01527 / 0.01902, 0.00869 / 0.01003
//   this design with a thread's base and fraction loads issued before the
//       level terms and 2 or 3 of its entries' loads at once, 64 or 128
//       threads (52-72 registers: fewer blocks an SM)
//                                             0.01694-0.01949 / 0.00922-0.01136
//   (c) each coarse level's four x-lines of the row's cell staged in
//       shared memory first, the corners read from there, 64 / 128 threads
//                                             0.02493 / 0.02330, 0.01244 / 0.01266
// Neither more loads in flight nor fewer L2 gathers paid: what holds the
// kernel is not established (PERF.md §7).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define PVD_MAX_LEVELS 32
#define PVD_MAX_BAKED 8
#define K13_LEVELS 4  // the background grid's (bg_grid_spec)
#define K13_THREADS 128
#define K7_THREADS 128
#define K11_SPAN 16  // cell levels a K11 block (a warp each)
#define K10_SPAN 16  // cell levels a K10 block (a warp each)
#define K1_POINTS 64  // points a K1 block
#define K1_PER 2  // levels a K1 thread
#define K1_MAX_THREADS 512  // 8 level groups of K1_POINTS threads
#define K1_SPAN (K1_MAX_THREADS / K1_POINTS * K1_PER)  // levels a K1 block
#define K15_POINTS 64  // points a K15 block (a thread per dense level each)
#define K16_THREADS 128  // threads a K16 block (a fine row)

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

// K10: a block per 32 consecutive points of the ray-major stream (a lane
// each) and up to K10_SPAN cell level entries (blockIdx.y takes the rest),
// a warp per entry: the level constants are warp-uniform, a warp's lanes
// are consecutive samples at one level (at the coarse cell levels a ray's
// samples share a lattice cell, and their lanes load the same row in one
// instruction).  A lane reads its point's x01, forms its lattice with
// corner_setup / corner_weight / cell_row (the weights and rows bit for
// bit the first design's), loads its row as four float4s and sums the 8
// corners in corner order into the block's shared tile ([32, 2 m] floats,
// rows of odd stride); then the block writes each point's run of cell
// slots (consecutive slots: the entry checks it) with consecutive lanes,
// as floats, so neither x01 nor out needs more than a float's alignment.
__global__ void __launch_bounds__(32 * K10_SPAN)
    hash_cell_fwd_kernel(const float* __restrict__ x01,
                         const float4* __restrict__ cell,
                         float* __restrict__ out, long long n_points,
                         HashLevels lv) {
  __shared__ float tile[32 * (2 * K10_SPAN + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = blockIdx.y * K10_SPAN, m = min(lv.n_levels - e0, K10_SPAN);
  const int st = 2 * m + 1, l = e0 + warp;  // st odd: no bank conflicts
  const long long n0 = (long long)blockIdx.x * 32;
  const int rows = (int)min(32LL, n_points - n0);
  if (warp < m && lane < rows) {
    float x[3], z, a0, a1;
    load_point<3>(x01, n0 + lane, x);
    if (nan_or_outside<3>(x, z)) {
      a0 = a1 = z;
    } else {
      const Corners<3> c = corner_setup<3>(x, l, lv);
      const float4* r = cell + 4 * cell_row(c, l, lv);
      const float4 v[4] = {__ldg(r), __ldg(r + 1), __ldg(r + 2),
                           __ldg(r + 3)};
      a0 = a1 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w0 = corner_weight<3>(c, 2 * q);
        const float w1 = corner_weight<3>(c, 2 * q + 1);
        a0 = __fmaf_rn(w0, v[q].x, a0);
        a1 = __fmaf_rn(w0, v[q].y, a1);
        a0 = __fmaf_rn(w1, v[q].z, a0);
        a1 = __fmaf_rn(w1, v[q].w, a1);
      }
    }
    tile[lane * st + 2 * warp] = a0;
    tile[lane * st + 2 * warp + 1] = a1;
  }
  __syncthreads();
  const int w2 = 2 * m;
  const long long ostride = 2LL * lv.out_levels;
  float* o = out + n0 * ostride + 2 * lv.level[e0];
  for (int e = threadIdx.x; e < rows * w2; e += blockDim.x) {
    const int r = e / w2;
    o[r * ostride + (e - r * w2)] = tile[r * st + (e - r * w2)];
  }
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

// K15: a block of (Ld, K15_POINTS) threads, a thread per (point, dense
// level j = threadIdx.x), level fastest; entry j of lv is dense level j,
// whose slot is level[0] + j (the entry checks that the slots are
// consecutive); entry 0 carries the finest dense level's side and scale.
__global__ void hash_baked_fwd_kernel(const float* __restrict__ x01,
                                      const float2* __restrict__ baked,
                                      float2* __restrict__ out,
                                      long long n_points, HashLevels lv) {
  const long long n = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (n >= n_points) return;
  const int ld = lv.n_levels, j = threadIdx.x;
  float2* o = out + n * lv.out_levels + lv.level[0] + j;
  float x[3], z;
  load_point<3>(x01, n, x);
  if (nan_or_outside<3>(x, z)) {
    *o = make_float2(z, z);
    return;
  }
  const Corners<3> c = corner_setup<3>(x, 0, lv);
  float2 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = __ldg(baked + (long long)corner_row<3>(c, k, 0u) * ld + j);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight<3>(c, k);
    a0 = __fmaf_rn(w, v[k].x, a0);
    a1 = __fmaf_rn(w, v[k].y, a1);
  }
  *o = make_float2(a0, a1);
}

// K16: a block per fine row (y, z) = (blockIdx.x, blockIdx.y) of side_f
// vertices x.  Entry j of lv is dense level j (the last one the finest).
// The block first sets out each level's row-uniform terms: the table row
// of the y and z bases, offset + by * s + bz * s^2 (the finest level's b
// is the vertex itself, so its row is the copy's), and the y and z
// weights.  Then thread e of the row's side_f * Ld entries takes level
// e / side_f, vertex e % side_f, x fastest, so adjacent lanes gather
// adjacent rows of one table; the finest level copies its contiguous
// float2s.  Results are staged as the row's [side_f][Ld] float2s and
// stored as its contiguous run by consecutive lanes.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) hash_bake_kernel(
    const float2* __restrict__ table, const int* __restrict__ b,
    const float* __restrict__ f, float2* __restrict__ baked, int side_f,
    HashLevels lv) {
  extern __shared__ float2 k16_row[];  // [side_f][ld]
  __shared__ long long k16_base[PVD_MAX_LEVELS];
  __shared__ int k16_side[PVD_MAX_LEVELS];
  __shared__ float k16_w[PVD_MAX_LEVELS][4];  // 1 - fy, fy, 1 - fz, fz
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
    k16_base[t] = off + (long long)by * s + (long long)bz * s * s;
    k16_side[t] = (int)s;
    k16_w[t][0] = __fsub_rn(1.f, fy);
    k16_w[t][1] = fy;
    k16_w[t][2] = __fsub_rn(1.f, fz);
    k16_w[t][3] = fz;
  }
  __syncthreads();
  // b and f are [Ld, side_f], so entry e's x base and fraction are b[e],
  // f[e] (the finest level's base is x itself)
  for (int e = t; e < n; e += THREADS) {
    const int j = e / side_f, x = e - j * side_f;
    const float2* row = table + k16_base[j] + __ldg(b + e);
    float2 v;
    if (j == ld - 1) {  // the finest dense level: its own vertex
      v = __ldg(row);
    } else {
      const long long s = k16_side[j];
      const float fx = __ldg(f + e);
      const float wx[2] = {__fsub_rn(1.f, fx), fx};
      float2 c[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[k] = __ldg(row + (k & 1) + ((k >> 1) & 1) * s
                     + ((k >> 2) & 1) * s * s);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float w = __fmul_rn(__fmul_rn(wx[k & 1], k16_w[j][(k >> 1) & 1]),
                                  k16_w[j][2 + ((k >> 2) & 1)]);
        a0 = __fadd_rn(a0, __fmul_rn(c[k].x, w));
        a1 = __fadd_rn(a1, __fmul_rn(c[k].y, w));
      }
      v = make_float2(a0, a1);
    }
    k16_row[x * ld + j] = v;
  }
  __syncthreads();
  float2* dst = baked + ((long long)z * side_f + y) * side_f * ld;
  for (int e = t; e < n; e += THREADS) dst[e] = k16_row[e];
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

// K10: the entries are consecutive level slots (the cell levels are the
// finest hashed ones); the cell table 16-byte aligned (the wrapper checks
// it); a block per 32 points and up to K10_SPAN entries
extern "C" int pvd_hash_cell_fwd(const float* x01, const float* cell_table,
                                 float* out, long long n_points, HashLevels lv,
                                 void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  bool ok = lv.n_levels <= PVD_MAX_LEVELS &&
            lv.level[0] + lv.n_levels <= lv.out_levels;
  for (int l = 1; ok && l < lv.n_levels; ++l)
    ok = lv.level[l] == lv.level[0] + l;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int span = lv.n_levels < K10_SPAN ? lv.n_levels : K10_SPAN;
  const dim3 blocks((unsigned)((n_points + 31) / 32),
                    (unsigned)((lv.n_levels + K10_SPAN - 1) / K10_SPAN));
  hash_cell_fwd_kernel<<<blocks, 32 * span, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float4*>(cell_table), out, n_points, lv);
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

// K15: the dense levels in consecutive slots (they are levels 0..Ld-1 of
// the grid); a block per K15_POINTS points
extern "C" int pvd_hash_baked_fwd(const float* x01, const float* baked,
                                  float* out, long long n_points,
                                  HashLevels lv, void* stream) {
  if (n_points == 0 || lv.n_levels == 0) return 0;
  const int ld = lv.n_levels;
  bool ok = ld <= PVD_MAX_BAKED && lv.level[0] + ld <= lv.out_levels;
  for (int j = 1; ok && j < ld; ++j) ok = lv.level[j] == lv.level[0] + j;
  if (!ok) return (int)cudaErrorInvalidValue;
  hash_baked_fwd_kernel<<<(unsigned)((n_points + K15_POINTS - 1) /
                                     K15_POINTS),
                          dim3(ld, K15_POINTS), 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(baked),
      reinterpret_cast<float2*>(out), n_points, lv);
  return (int)cudaGetLastError();
}

// K16: a block per fine row, whose staging takes side_f * Ld * 8 bytes of
// shared memory (2,920 at side 73, 5 levels; 8,512 at side 152, 7 levels:
// a grid past 48 KB is refused)
extern "C" int pvd_hash_bake(const float* table, const int* b, const float* f,
                             float* baked, int side_f, HashLevels lv,
                             void* stream) {
  if (lv.n_levels == 0 || side_f <= 0) return 0;
  const size_t smem = (size_t)side_f * lv.n_levels * sizeof(float2);
  if (lv.n_levels > PVD_MAX_LEVELS || side_f > 65535 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  hash_bake_kernel<K16_THREADS>
      <<<dim3(side_f, side_f), K16_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(table), b, f,
      reinterpret_cast<float2*>(baked), side_f, lv);
  return (int)cudaGetLastError();
}

// 1 when K11 was built with float4 atomics, 0 with scalar ones.
extern "C" int pvd_hash_cell_vector_atomics() { return PVD_VECTOR_ATOMICS; }
