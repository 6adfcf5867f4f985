// Trilinear point sampler over channels-last 3D tables (K2) and its backward
// (K2-bwd).
//
// Replaces the TPU kernels occformer_tpu/ops/trilerp.py:_build_op.call_fwd
// (:476) and call_bwd (:493), public trilerp_gather_slab (:534): trilinear
// samples of a [G, X*Y, Z*C] slab at [G, S, 3] coordinates in [-1, 1].  The
// slab is the same memory as the channels-last table [G, X, Y, Z, C] taken
// here, so the port needs no permute and no padding.  coords[g, s, i]
// indexes spatial axis i (x, y, z), as in the JAX package.
//
//   out[g, s, c] = sum over the 8 corners of corner_weight * table[g, corner, c]
//
// Unnormalization and padding follow F.grid_sample (mode="bilinear" in 5-D):
//   align_corners=1: pix = (coord + 1) / 2 * (size - 1)
//   align_corners=0: pix = ((coord + 1) * size - 1) / 2
//   border: pix is clipped to [0, size - 1] before the corners are taken
//           (its gradient is 0 where clipped, and on the clip limits, as in
//           torch's clip_coordinates_set_grad);
//   zeros:  a corner outside the table contributes nothing.
// The sum is kept in float32.  Tables are float32, bfloat16 or uint8 (a
// 0/1 mask read as its value); the output is the table's type for the two
// float types and float32 for uint8.
//
// The one-hot MXU matmuls, row windows and escape passes of the Pallas kernel
// exist only because the TPU gathers badly; here every thread gathers
// directly.
//
// Forward, two paths; ops/trilerp.py:fwd_path picks one by the row and the
// table's alignment.
// * Row-wide (trilerp_fwd_rows_kernel): tables whose rows are whole 16-byte
//   vectors (C a multiple of 8 in bf16, of 4 in float32; the per-layer loss
//   route's C = 192 feature).  The first design, one thread per output
//   (g, s, c), redid a point's axis, corner and weight arithmetic for every
//   channel and loaded 2 bytes a thread, a warp reading 64 bytes of a
//   384-byte corner row at a time: 0.53 ms at the candidate readout, 9% of
//   its bound.  Here a group of `lanes` lanes (a power of two; by default
//   the fewest that hold a row at 3 vectors a lane: 8 at C = 192 bf16)
//   takes one point: each lane computes the axes and weights once, then
//   issues the 16-byte loads of its vectors of all 8 corners before any
//   FMA, sums in float32 registers and stores each vector once, rounded to
//   the table's type.  Neighbouring lanes read neighbouring vectors of a
//   corner row, so a group reads whole rows.
// * Narrow (trilerp_fwd_narrow_kernel; fwd_path keeps the first design's
//   name for it, "scalar"): everything else, at any C, dtype and alignment (the
//   uint8 GT masks, the batched route's float32 C = 17 and C = 1 volumes and
//   bf16 C = 100 match volumes, unaligned tables).  The first design ran one
//   thread per output (g, s, c): every channel's thread redid the point's
//   axes and 8 weights, loaded 1-4 bytes a corner with its loads and FMAs
//   interleaved, and at C = 1 loaded a point's two adjacent z corners
//   apart: 0.884 / 0.513 / 0.138 ms at the batched match / candidate /
//   random-fill readouts, 17-46% of their bounds.  Here, as on the row-wide
//   path, a group of lanes (a power of two) takes a point; its row is read
//   in chunks of `vec` elements, one load each, as wide as the row and the
//   table's alignment allow (ops/trilerp.py:narrow_vec: 8-byte loads at
//   C = 100 bf16, 4-byte at C = 17 float32); each lane computes the
//   weights once and issues the loads of its chunks of all 8 corners before
//   any FMA; the sums are float32 in (dx, dy, dz) corner order and each
//   chunk is stored once.  At C = 1 a lane takes a point (or several,
//   NARROW_POINTS_PER_LANE).  Sweeps (tools/time_backwards.py --sweep, H100
//   80GB HBM3 at 700 W, ms by events; two sweeps in two calls where two
//   ranges are given): lanes 1 / 2 / 4 / 8 / 16 / 32 at the batched match
//   readout (C = 100 bf16, 25 chunks) 2.08-2.11 / 0.827-0.856 / 0.369-0.377
//   / 0.312-0.315 / 0.390-0.396 / 0.333-0.339, at its candidates (C = 17
//   float32, 17 chunks) 1.31-1.33 / 0.650-0.659 / 0.410-0.413 /
//   0.374-0.379 / 0.487-0.493 / 0.622-0.629, at the per-layer route's GT
//   table (C = 17 uint8) 0.174 / 0.082 / 0.064 / 0.069-0.070 / 0.082 /
//   0.094: narrow_lanes takes the fewest lanes that hold the row at 4
//   chunks a lane (NARROW_CHUNKS_PER_LANE), 8 at all three (4 was 9%
//   faster at the uint8 table in one sweep and tied in another, and 10%
//   slower at the float32 one); points a
//   lane 1 / 2 / 4 at the GT masks (C = 1 uint8) 0.047-0.055 /
//   0.048-0.056 / 0.047-0.055 (the wrapper's host time: 0.010-0.012 ms of
//   device time) and at the random fill (C = 1 float32) 0.129-0.135 /
//   0.131-0.139 / 0.164-0.169: one.  Tried and dropped: at C = 1 one load
//   of a point's two adjacent z corners where both lie inside and the pair
//   is aligned gave nothing (device ms with / without, in turns in one call:
//   GT masks 0.0122-0.0123 / 0.0104-0.0116, random fill 0.0953-0.0954 /
//   0.0913-0.0983); capping the registers at 32 for 8 blocks of 256 threads
//   an SM spilled and took 2.8x as long at the random fill.
// fwd_path sets no width threshold beyond whole vectors.  Both paths at the
// candidate readout's shape (bf16 [1, 128, 128, 16, C], 150528 points,
// border), ms narrow / row-wide, H100 80GB HBM3 at 700 W: two sweeps with
// the first design in place of the narrow kernel, C = 8 0.041-0.055 /
// 0.034-0.054, 32 0.093-0.109 / 0.047-0.061, 64 0.172-0.183 /
// 0.066-0.067, 192 0.513-0.524 / 0.213-0.224; with the narrow kernel C = 8
// 0.054 / 0.047-0.048, 16
// 0.062 / 0.051, 32 0.096-0.097 / 0.056, 40 0.075-0.076 / 0.064-0.065, 48
// 0.078 / 0.070, 56 0.101-0.102 / 0.073, 64 0.113 / 0.076, 128 0.145-0.147
// / 0.129-0.130, 192 0.181 / 0.212: the row-wide path wins up to C = 128
// and loses at 192, where it runs; since it shares point_corners, 0.187-0.194
// / 0.192-0.203 at 192 and 0.152-0.161 / 0.152-0.157 at 128 (ROADMAP B).
// Lanes per point of the row-wide path at C = 192 (two sweeps): 1
// 0.266-0.300, 2 0.225-0.247, 4 0.216-0.240, 8 0.202-0.232, 16
// 0.196-0.226, 32 0.198-0.226 ms: row_lanes' choice, 8, holds the row at 3
// vectors a lane.
//
// Backward, two paths; ops/trilerp.py:bwd_path picks one by the row width C.
// The threshold, SEGMENTED_MIN_C = 48, came from tools/time_backwards.py
// --sweep with the first, atomic, narrow path: both paths at the candidate
// readout's shape (bf16 [1, 128, 128, 16, C], 150528 points, border) on an
// H100 80GB HBM3 at 700 W, ms narrow / segmented, C = 8 0.07-0.14 /
// 0.21-0.23, 32 0.18 / 0.21-0.22, 48 0.23-0.27 / 0.25-0.26, 192 1.01-1.03 /
// 0.35-0.36.  With the per-column gather the same sweep gives C = 8
// 0.125-0.140 / 0.193-0.201, 16 0.174-0.185 / 0.196-0.198, 32 0.252-0.264 /
// 0.204-0.213, 48 0.298-0.320 / 0.193-0.208, 192 0.906-0.920 / 0.322-0.324:
// the crossing moved between 16 and 32; no loss shape lies between, and the
// threshold stays.
//
// * Wide rows (C a multiple of 8 and at least SEGMENTED_MIN_C; the
//   per-layer loss route's C = 192 feature): a per-voxel segmented
//   gather that writes every d_table row once, in the table's dtype, with no
//   float atomics and no float32 buffer.
//     1-4. the counting sort of segment_sort.cuh with CornerKeys: one entry
//        per (point, corner inside the table), keyed by the corner's voxel
//        row (make_axis, the same in-range test as the forward), every
//        row's entries in ascending point order;
//     5. gather: one thread per (row, 8-channel chunk), C/8 threads per row
//        (24 at C = 192), walks its segment in that order, recomputes the
//        corner weight from the point's coordinates, adds w * gout[point,
//        chunk] in float32 registers from 16-byte loads and stores the chunk
//        once; a row without entries gets zeros.
// * Narrow rows (everything else: the batched loss route's C = 17 and C = 1
//   per-slot volumes, G up to 170): a per-column segmented gather that
//   writes every d_table column once, in the table's dtype, with no float
//   atomics and no float32 buffer.  The first design ran one thread per
//   (g, s, c) with float32 atomics into a zeroed d_table, each thread
//   redoing the point's three make_axis and 64-bit index arithmetic: 205 M
//   atomics into a 178 MB buffer (3.6x L2) at the batched candidates, 0.70
//   ms, and its sums changed from run to run.  Here:
//     1-4. the counting sort of segment_sort.cuh with ColumnKeys: one entry
//        per point with a corner inside its table, keyed by its lower
//        corner's (x, y) column g*X*Y + x0*Y + y0 (clamped into the table,
//        as ops/loss_gather.py:row_key, so points the loss sorted by row
//        arrive sorted); 164 K keys at the candidates, 2.8 M at the random
//        fill, against 2.6 M and 44.6 M voxels;
//     5. gather (trilerp_bwd_tiles_kernel): a block takes a tile of
//        output columns (g, x, y) of one table, a group of column_lanes
//        lanes per column (the fewest, a power of two, that give each
//        channel a lane: 32 at C = 17, a tile of 1 x 8 columns; 1 at
//        C = 1, a tile of 8 x 32).  The points that touch the tile are the
//        lists of the key columns one row and one column back from it: per
//        key row one contiguous span of the sorted entries, staged
//        COL_STAGE entries at a time into shared memory, a thread an entry
//        (its gout row in float32, its corners and weights from one
//        make_axis per axis).  Lane c of a column then walks the lists of
//        the four key columns that touch it, (x-1, y-1), (x-1, y),
//        (x, y-1), (x, y), in that order, each in ascending point order, and
//        adds w * gout to the column's two z corners of channel c in a
//        float32 tile of the outputs in shared memory.  Each output is added
//        to by one lane in a fixed order, and the tile is stored once.
//   Two calls give bit-identical d_tables on both paths; the int32 workspace
//   (offsets, cursor, tile sums, the fill's item indices, the sorted
//   entries) is allocated by the wrapper.
// Coordinate gradients (asked for by no loss readout; by the tests and the
// smoke run's float32 case) take an atomic kernel on both paths,
// trilerp_bwd_coords_kernel: each (g, s, c) thread adds its channel's share
// of the three derivatives into a zeroed [G, S, 3] buffer; it reads the
// table, which only the coordinate gradient needs.
//
// Bounds on an H100 SXM at the flagship's candidate readout (table
// [1, 128, 128, 16, 192] bf16, 100.7 MB; S = 150528): both are memory-bound.
// Forward: table 100.7 MB + coords 1.8 MB read, out 57.8 MB written, about
// 160 MB, about 48 us at 3.35 TB/s.  The table is twice L2 and the points
// spread over it, so in fact each point reads its 8 corner rows whole
// (384 bytes each, 462 MB in all) plus the 57.8 MB written: a realistic
// floor of about 0.155 ms, which the row-wide path approaches.  Backward: gout 57.8 MB + coords 1.8 MB
// read, d_table 100.7 MB written in the table's dtype, about 160 MB, about
// 48 us.  The gather writes d_table once (no 201 MB float32 buffer, no
// zero-fill, no cast); each gout row is read by up to 8 rows' threads, the
// repeats mostly from L2.  The atomic path's float32 d_table at this shape
// would be 201 MB, four times L2, so every atomic would be a DRAM
// read-modify-write.  Narrow path at the batched candidates (float32 table
// [10, 128, 128, 16, 17], 10 x 150528 points): gout 102.4 MB + coords 18.1
// MB read, d_table 178.3 MB written, 0.0892 ms; at the random fill ([170,
// 128, 128, 16, 1], 170 x 12544): 8.5 + 25.6 + 178.3 MB, 0.0634 ms.  Both
// are d_table writes above all; the gather reads each point's gout row and
// coordinates once per tile that its four columns fall in (about 2.25
// tiles at C = 17).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chunk_io.cuh"
#include "segment_sort.cuh"

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Axis {
  int i0;         // lower corner index (may lie outside [0, size))
  float w[2];     // lerp weights of the lower and upper corner
  float dpix;     // d pix / d coord, 0 where border clipping flattens it
};

__device__ __forceinline__ Axis make_axis(float coord, int size, int align,
                                          int border) {
  float pix, dpix;
  if (align) {
    pix = (coord + 1.f) * 0.5f * (float)(size - 1);
    dpix = 0.5f * (float)(size - 1);
  } else {
    pix = ((coord + 1.f) * (float)size - 1.f) * 0.5f;
    dpix = 0.5f * (float)size;
  }
  if (border) {
    const float hi = (float)(size - 1);
    if (pix <= 0.f || pix >= hi) dpix = 0.f;
    pix = fminf(fmaxf(pix, 0.f), hi);
  } else {
    // keeps the float-to-int conversion defined; a clamped position has
    // every corner outside the table, as the unclamped one has
    pix = fminf(fmaxf(pix, -2.f), (float)size + 1.f);
  }
  Axis a;
  const float f = floorf(pix);
  a.i0 = (int)f;
  a.w[1] = pix - f;
  a.w[0] = 1.f - a.w[1];
  a.dpix = dpix;
  return a;
}

// The 8 corners of point gs: each corner's voxel within its table (-1
// outside it, zeros padding) and its weight (0 outside), in (dx, dy, dz)
// order, q = dx * 4 + dy * 2 + dz.
__device__ __forceinline__ void point_corners(const float* __restrict__ coords,
                                              int64_t gs, int X, int Y, int Z,
                                              int align, int border,
                                              int (&row)[8], float (&w)[8]) {
  const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
  const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
  const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int q = dx * 4 + dy * 2 + dz;
        const int xi = ax.i0 + dx, yi = ay.i0 + dy, zi = az.i0 + dz;
        const bool ok = xi >= 0 && xi < X && yi >= 0 && yi < Y && zi >= 0 &&
                        zi < Z;
        w[q] = ok ? ax.w[dx] * ay.w[dy] * az.w[dz] : 0.f;
        row[q] = ok ? (xi * Y + yi) * Z + zi : -1;
      }
}

// ---- the narrow-row forward: a lane group per point, the widest loads the
// row allows ----

// A group of 2^lane_bits lanes takes PPL points at a time: the group's
// points p0, p0 + groups, ..., so that at each of the PPL slots the warp's
// groups hold neighbouring points (their coordinate reads and output stores
// are coalesced).  Every lane computes its points' axes, corners and
// weights (once per lane, not once per channel).  The row's nchunk = C / VEC
// chunks (VEC elements, one load each) are walked in passes: lane l takes
// chunks l, l + lanes, ..., CPT of them per pass, issues the loads of all 8
// corners of those chunks for its PPL points before any FMA, sums in float32
// registers in (dx, dy, dz) corner order and stores each chunk once.  A
// corner outside the table (zeros padding) is not loaded and has weight 0.
// PPL > 1 only at C = 1 (one lane, one chunk).
template <typename Tin, typename Tout, int VEC, int CPT, int PPL>
__global__ void __launch_bounds__(256)
trilerp_fwd_narrow_kernel(const Tin* __restrict__ table,
                          const float* __restrict__ coords,
                          Tout* __restrict__ out, int64_t n_pts, int S, int X,
                          int Y, int Z, int C, int align, int border,
                          int lane_bits) {
  using RawIn = typename Raw<VEC * sizeof(Tin)>::T;
  const int nchunk = C / VEC;
  const int lanes = 1 << lane_bits;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t & (lanes - 1));
  const int64_t groups = ((int64_t)gridDim.x * blockDim.x) >> lane_bits;
  const int64_t vol = (int64_t)X * Y * Z * C;  // elements of one table
  for (int64_t p0 = t >> lane_bits; p0 < n_pts; p0 += groups * PPL) {
    int row[PPL][8];
    float w[PPL][8];
    const Tin* tb[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int64_t gs = p0 + j * groups;
      if (gs < n_pts) {
        point_corners(coords, gs, X, Y, Z, align, border, row[j], w[j]);
        tb[j] = table + gs / S * vol;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          row[j][q] = -1;
          w[j][q] = 0.f;
        }
        tb[j] = table;
      }
    }
    for (int c0 = lane; c0 < nchunk; c0 += lanes * CPT) {
      RawIn r[PPL][8][CPT];
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            const int c = c0 + k * lanes;
            r[j][q][k] = (row[j][q] >= 0 && c < nchunk)
                             ? __ldg(reinterpret_cast<const RawIn*>(
                                         tb[j] + (int64_t)row[j][q] * C) + c)
                             : RawIn{};
          }
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int64_t gs = p0 + j * groups;
        float acc[CPT][VEC];
#pragma unroll
        for (int k = 0; k < CPT; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int k = 0; k < CPT; ++k) fma_chunk<Tin, VEC>(acc[k], r[j][q][k], w[j][q]);
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int c = c0 + k * lanes;
          if (gs < n_pts && c < nchunk) store_chunk<Tout, VEC>(out + gs * C + c * VEC, acc[k]);
        }
      }
    }
  }
}

// ---- the row-wide forward: 16-byte vectors of a row per lane ----

// One 16-byte vector of a table row: 8 bf16 or 4 float32 channels.
template <typename T> struct Vec16;
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec16<float> { static constexpr int N = 4; };

// a += w * (the vector's channels, as float)
__device__ __forceinline__ void fma16(float (&a)[8], const uint4& u, float w) {
  const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = wd[k];
    const float2 f = __bfloat1622float2(h);
    a[2 * k] = fmaf(w, f.x, a[2 * k]);
    a[2 * k + 1] = fmaf(w, f.y, a[2 * k + 1]);
  }
}
__device__ __forceinline__ void fma16(float (&a)[4], const uint4& u, float w) {
  a[0] = fmaf(w, __uint_as_float(u.x), a[0]);
  a[1] = fmaf(w, __uint_as_float(u.y), a[1]);
  a[2] = fmaf(w, __uint_as_float(u.z), a[2]);
  a[3] = fmaf(w, __uint_as_float(u.w), a[3]);
}
// the channels rounded once to the table's type, as one 16-byte vector
__device__ __forceinline__ uint4 pack16(const float (&a)[8]) {
  unsigned wd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    wd[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}
__device__ __forceinline__ uint4 pack16(const float (&a)[4]) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                    __float_as_uint(a[2]), __float_as_uint(a[3]));
}

// A group of 2^lane_bits lanes per point (g, s).  Every lane computes the
// point's axes, corners and weights (once per lane, not once per channel),
// then walks the row's nvec = C / N vectors: lane l takes vectors l,
// l + lanes, ..., VPT of them per pass, issues all 8 corners' loads of those
// vectors before any FMA, sums in float32 registers and stores each vector
// once.  A corner outside the table (zeros padding) is not loaded and has
// weight 0.  Neighbouring lanes read neighbouring vectors of one corner row.
template <typename T, int VPT>
__global__ void __launch_bounds__(256)
trilerp_fwd_rows_kernel(const T* __restrict__ table,
                        const float* __restrict__ coords, T* __restrict__ out,
                        int64_t n_pts, int S, int X, int Y, int Z, int C,
                        int align, int border, int lane_bits) {
  constexpr int N = Vec16<T>::N;
  const int nvec = C / N;
  const int lanes = 1 << lane_bits;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t & (lanes - 1));
  const int64_t step = ((int64_t)gridDim.x * blockDim.x) >> lane_bits;
  const int64_t vol_vec = (int64_t)X * Y * Z * nvec;
  for (int64_t gs = t >> lane_bits; gs < n_pts; gs += step) {
    int row[8];
    float w[8];
    point_corners(coords, gs, X, Y, Z, align, border, row, w);
    const uint4* tb =
        reinterpret_cast<const uint4*>(table) + gs / S * vol_vec;
    uint4* o = reinterpret_cast<uint4*>(out) + gs * nvec;
    for (int v0 = lane; v0 < nvec; v0 += lanes * VPT) {
      uint4 r[8][VPT];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int v = v0 + k * lanes;
          r[q][k] = (row[q] >= 0 && v < nvec) ? __ldg(tb + row[q] * nvec + v)
                                              : make_uint4(0u, 0u, 0u, 0u);
        }
      float acc[VPT][N];
#pragma unroll
      for (int k = 0; k < VPT; ++k)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[k][e] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int k = 0; k < VPT; ++k) fma16(acc[k], r[q][k], w[q]);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = v0 + k * lanes;
        if (v < nvec) o[v] = pack16(acc[k]);
      }
    }
  }
}

// The coordinate gradient (both backward paths): one thread per (g, s, c)
// adds its channel's share of the three derivatives into a zeroed d_coords
// with float32 atomics.
template <typename T>
__global__ void trilerp_bwd_coords_kernel(const T* __restrict__ table,
                                          const float* __restrict__ coords,
                                          const T* __restrict__ gout,
                                          float* __restrict__ d_coords, int64_t n_out,
                                          int S, int X, int Y, int Z, int C,
                                          int align, int border) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t vol = (int64_t)X * Y * Z * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const int c = (int)(i % C);
    const int64_t gs = i / C;
    const int64_t g = gs / S;
    const float go = load_f(gout + i);
    const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
    const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
    const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
    const int64_t off0 = g * vol + c;
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = ax.i0 + dx;
      if (xi < 0 || xi >= X) continue;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yi = ay.i0 + dy;
        if (yi < 0 || yi >= Y) continue;
        const int64_t row = ((int64_t)xi * Y + yi) * Z;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const int zi = az.i0 + dz;
          if (zi < 0 || zi >= Z) continue;
          const float v = load_f(table + off0 + (row + zi) * C);
          sx += (dx ? v : -v) * ay.w[dy] * az.w[dz];
          sy += (dy ? v : -v) * ax.w[dx] * az.w[dz];
          sz += (dz ? v : -v) * ax.w[dx] * ay.w[dy];
        }
      }
    }
    if (ax.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 0, go * sx * ax.dpix);
    if (ay.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 1, go * sy * ay.dpix);
    if (az.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 2, go * sz * az.dpix);
  }
}

// ---- the wide-row backward: per-voxel segmented gather ----

// fn(row) for each corner of point gs inside its table; row indexes the
// G*X*Y*Z voxels (g-major), in (dx, dy, dz) order.
template <typename Fn>
__device__ __forceinline__ void each_corner(const float* __restrict__ coords,
                                            int64_t gs, int S, int X, int Y,
                                            int Z, int align, int border,
                                            Fn fn) {
  const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
  const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
  const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
  const int64_t row0 = gs / S * ((int64_t)X * Y * Z);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int xi = ax.i0 + dx;
    if (xi < 0 || xi >= X) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = ay.i0 + dy;
      if (yi < 0 || yi >= Y) continue;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int zi = az.i0 + dz;
        if (zi < 0 || zi >= Z) continue;
        fn(row0 + ((int64_t)xi * Y + yi) * Z + zi);
      }
    }
  }
}

// The wide path's sort keys: each in-range corner voxel of point gs.
struct CornerKeys {
  using Entry = int;
  const float* coords;
  int S, X, Y, Z, align, border;
  template <typename Fn>
  __device__ __forceinline__ void operator()(int64_t gs, Fn fn) const {
    each_corner(coords, gs, S, X, Y, Z, align, border, fn);
  }
  __device__ __forceinline__ int entry(int64_t gs) const { return (int)gs; }
};

// 8 channels as float from one 16-byte (bf16) or two 16-byte (float32) loads
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w[k];
    const float2 f = __bfloat1622float2(h);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float corner_w(const Axis& a, int i) {
  return i == a.i0 ? a.w[0] : a.w[1];
}

// 5. gather: thread (row, chunk) sums its segment's w * gout[point, chunk]
template <typename T>
__global__ void trilerp_bwd_gather_kernel(const float* __restrict__ coords,
                                          const T* __restrict__ gout,
                                          const int* __restrict__ offs,
                                          const int* __restrict__ sorted,
                                          T* __restrict__ d_table, int64_t n_work,
                                          int X, int Y, int Z, int C, int align,
                                          int border) {
  const int nchunk = C >> 3;
  const int64_t vol = (int64_t)X * Y * Z;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n_work;
       t += stride) {
    const int chunk = (int)(t % nchunk);
    const int64_t row = t / nchunk;
    const int64_t v = row % vol;
    const int zi = (int)(v % Z);
    const int yi = (int)(v / Z % Y);
    const int xi = (int)(v / ((int64_t)Y * Z));
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    const int end = offs[row + 1];
    for (int j = offs[row]; j < end; ++j) {
      const int64_t gs = sorted[j];
      const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
      const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
      const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
      const float w = corner_w(ax, xi) * corner_w(ay, yi) * corner_w(az, zi);
      float go[8];
      load8(gout + gs * C + chunk * 8, go);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(w, go[k], acc[k]);
    }
    store8(d_table + row * C + chunk * 8, acc);
  }
}

// ---- the narrow-row backward: per-column segmented gather ----

// A corner index i0 or i0 + 1 lies in [0, size).
__device__ __forceinline__ bool axis_touches(int i0, int size) {
  return i0 >= -1 && i0 < size;
}

// The narrow path's sort key: point gs's column g*X*Y + x0*Y + y0, its lower
// corner's (x, y) clamped into the table (as ops/loss_gather.py:row_key);
// none for a point with no corner inside its table.
struct ColumnKeys {
  using Entry = int;
  const float* coords;
  int S, X, Y, Z, align, border;
  template <typename Fn>
  __device__ __forceinline__ void operator()(int64_t gs, Fn fn) const {
    const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
    const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
    const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
    if (!axis_touches(ax.i0, X) || !axis_touches(ay.i0, Y) || !axis_touches(az.i0, Z))
      return;
    const int x = min(max(ax.i0, 0), X - 1), y = min(max(ay.i0, 0), Y - 1);
    fn(gs / S * ((int64_t)X * Y) + (int64_t)x * Y + y);
  }
  __device__ __forceinline__ int entry(int64_t gs) const { return (int)gs; }
};

// The narrow path's gather works on tiles of output columns; these set its
// shape and staging: threads a block, z slices a pass, and sorted entries
// staged in shared memory at a time.
constexpr int COL_THREADS = 256;
constexpr int COL_ZB = 16;
constexpr int COL_STAGE = 256;

// A block takes a tile of TX x TY output columns of one table (TY
// consecutive y, TX consecutive x; TX * TY * lanes = COL_THREADS), a group
// of 2^lane_bits lanes per column, lane c taking channel cb + c.  The points
// that touch the tile are those of the key columns (x, y) with x in
// [x_t - 1, x_t + TX) and y in [y_t - 1, y_t + TY): for each such x one
// contiguous span of the sorted entries.  The block stages those spans,
// COL_STAGE entries at a time, into shared memory, a thread an entry: the
// entry's point, then its gout row (CLMAX or fewer channels, the row's loads
// in flight together with the coordinates') in float32, and its corner
// indices and weights from one make_axis per axis; then every lane walks the
// entries of its column's four lists, (x-1, y-1), (x-1, y), (x, y-1),
// (x, y) in that order, each in ascending point order, adding w * gout to
// the column's two z corners of its channel in a float32 tile of the
// outputs in shared memory (COL_ZB slices, the tile's channels a pass).
// Each output is added to by one lane in a fixed order, whatever the tile
// shape: the same bits on every call.  The tile's outputs, TX runs of
// contiguous columns, are then written once with coalesced 16-byte stores
// where the runs allow them.  Every phase waits on loads, so residency and
// dependent rounds set the pace (tools/time_backwards.py, batched
// candidates with points sorted by column / random fill, device ms, H100
// 80GB HBM3 at 700 W, each pair in turns in one call): at most 40
// registers a thread, for 6 blocks an SM (the shared memory at C = 17
// allows 6), 0.821 -> 0.631 / 0.360 -> 0.288; a thread loading its
// entry's whole gout row itself, in flight with its coordinates, instead
// of the block loading the rows after a barrier, 0.636 -> 0.561 / 0.289 ->
// 0.276-0.280 (without the register cap 0.818 / 0.317); 8 blocks (32
// registers, 128 entries a stage) were no faster.
template <typename T, int CLMAX>
__global__ void __launch_bounds__(COL_THREADS, 6)
trilerp_bwd_tiles_kernel(const float* __restrict__ coords, const T* __restrict__ gout,
                         const int* __restrict__ offs, const int* __restrict__ sorted,
                         T* __restrict__ d_table, int G, int X, int Y, int Z, int C,
                         int align, int border, int lane_bits, int TY) {
  extern __shared__ float smem[];
  const int lanes = 1 << lane_bits;
  const int CL = min(C, lanes);  // channels a pass
  const int cols = COL_THREADS >> lane_bits;
  float* s_acc = smem;                                        // [cols][COL_ZB][CL]
  int* s_x0 = reinterpret_cast<int*>(s_acc + cols * COL_ZB * CL);  // lower corner
  int* s_y0 = s_x0 + COL_STAGE;
  int* s_z0 = s_y0 + COL_STAGE;
  float* s_w = reinterpret_cast<float*>(s_z0 + COL_STAGE);    // 6 weights an entry
  float* s_g = s_w + 6 * COL_STAGE;                           // CL channels an entry
  __shared__ int s_beg[COL_THREADS + 1], s_len[COL_THREADS + 1];
  const int TX = cols / TY;
  const int tiles_y = (Y + TY - 1) / TY, tiles_x = (X + TX - 1) / TX;
  const int lane = threadIdx.x & (lanes - 1);
  const int col = threadIdx.x >> lane_bits;
  const int tx = col / TY, ty = col - tx * TY;
  const int64_t n_tiles = (int64_t)G * tiles_x * tiles_y;
  // one pass holds every output of the tile: the outputs can be copied out
  // as the runs of contiguous columns they are
  const bool one_pass = Z <= COL_ZB && C <= lanes;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int g = (int)(tile / ((int64_t)tiles_x * tiles_y));
    const int t2 = (int)(tile - (int64_t)g * tiles_x * tiles_y);
    const int x_t = t2 / tiles_y * TX, y_t = t2 % tiles_y * TY;
    const int x = x_t + tx, y = y_t + ty;
    const bool mine = x < X && y < Y;
    // the key spans: rows [r_lo, r_hi), each the keys (row, y_lo .. y_hi - 1)
    const int r_lo = max(x_t - 1, 0), r_hi = min(x_t + TX, X);
    const int n_rows = r_hi - r_lo;
    const int y_lo = max(y_t - 1, 0), y_hi = min(y_t + TY, Y);
    const int64_t key0 = (int64_t)g * X * Y;
    __syncthreads();  // the previous tile is done with the shared arrays
    if (threadIdx.x < n_rows) {
      const int64_t k = key0 + (int64_t)(r_lo + threadIdx.x) * Y;
      const int b0 = offs[k + y_lo];
      s_beg[threadIdx.x] = b0;
      s_len[threadIdx.x] = offs[k + y_hi] - b0;
    }
    __syncthreads();
    int total = 0;
    for (int r = 0; r < n_rows; ++r) total += s_len[r];
    // this column's two stretches (rows x - 1 and x), as positions of the
    // spans laid end to end
    int pa[2] = {0, 0}, pb[2] = {0, 0};
    if (mine) {
      int base = 0;
      for (int ri = 0; ri < n_rows; ++ri) {
        const int r = r_lo + ri;
        if (r == x - 1 || r == x) {
          const int64_t k = key0 + (int64_t)r * Y;
          const int a = base + offs[k + max(y - 1, 0)] - s_beg[ri];
          const int b = base + offs[k + y + 1] - s_beg[ri];
          if (r == x) {
            pa[1] = a;
            pb[1] = b;
          } else {
            pa[0] = a;
            pb[0] = b;
          }
        }
        base += s_len[ri];
      }
    }
    for (int zb = 0; zb < Z; zb += COL_ZB) {
      for (int cb = 0; cb < C; cb += lanes) {
        const int c = cb + lane;
        for (int i = threadIdx.x; i < cols * COL_ZB * CL; i += COL_THREADS) s_acc[i] = 0.f;
        for (int s0 = 0; s0 < total; s0 += COL_STAGE) {
          const int n_here = min(COL_STAGE, total - s0);
          __syncthreads();  // the previous stage is read, s_acc zeroed
          for (int e = threadIdx.x; e < n_here; e += COL_THREADS) {
            int pos = s0 + e, ri = 0;
            while (pos >= s_len[ri]) pos -= s_len[ri++];
            const int gs = sorted[s_beg[ri] + pos];
            float gv[CLMAX];  // the entry's gout row, its loads in flight together
#pragma unroll
            for (int ch = 0; ch < CLMAX; ++ch)
              gv[ch] = ch < CL && cb + ch < C ? to_f(gout[(int64_t)gs * C + cb + ch]) : 0.f;
            const Axis ax = make_axis(coords[(int64_t)gs * 3 + 0], X, align, border);
            const Axis ay = make_axis(coords[(int64_t)gs * 3 + 1], Y, align, border);
            const Axis az = make_axis(coords[(int64_t)gs * 3 + 2], Z, align, border);
            s_x0[e] = ax.i0;
            s_y0[e] = ay.i0;
            s_z0[e] = az.i0 - zb;
            s_w[6 * e + 0] = ax.w[0];
            s_w[6 * e + 1] = ax.w[1];
            s_w[6 * e + 2] = ay.w[0];
            s_w[6 * e + 3] = ay.w[1];
            s_w[6 * e + 4] = az.w[0];
            s_w[6 * e + 5] = az.w[1];
#pragma unroll
            for (int ch = 0; ch < CLMAX; ++ch)
              if (ch < CL) s_g[e * CL + ch] = gv[ch];
          }
          __syncthreads();
          if (mine && c < C) {
            float* acc = s_acc + col * COL_ZB * CL + lane;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e1 = min(pb[h], s0 + n_here) - s0;
              for (int e = max(pa[h], s0) - s0; e < e1; ++e) {
                const int dx = x - s_x0[e], dy = y - s_y0[e];
                if (dx < 0 || dx > 1 || dy < 0 || dy > 1) continue;
                const float wxy = s_w[6 * e + dx] * s_w[6 * e + 2 + dy];
                const float go = s_g[e * CL + lane];
                const int z = s_z0[e];
                if (z >= 0 && z < COL_ZB)
                  acc[z * CL] = fmaf(wxy * s_w[6 * e + 4], go, acc[z * CL]);
                if (z + 1 >= 0 && z + 1 < COL_ZB)
                  acc[(z + 1) * CL] = fmaf(wxy * s_w[6 * e + 5], go, acc[(z + 1) * CL]);
              }
            }
          }
        }
        __syncthreads();  // the tile's sums are complete
        if (one_pass) {
          // each tile row's columns (x, y_t ..) are contiguous in d_table, as
          // they are in s_acc
          const int run_cols = min(TY, Y - y_t), run = run_cols * Z * C;
          for (int rx = 0; rx < TX && x_t + rx < X; ++rx) {
            T* out = d_table + (key0 + (int64_t)(x_t + rx) * Y + y_t) * Z * C;
            const float* src = s_acc + rx * TY * COL_ZB * CL;
            if (sizeof(T) == 4 && Z == COL_ZB && C == CL && run % 4 == 0 &&
                ((uintptr_t)out & 15) == 0) {
              for (int v = threadIdx.x; v < run / 4; v += COL_THREADS)
                reinterpret_cast<float4*>(out)[v] = reinterpret_cast<const float4*>(src)[v];
            } else {
              for (int v = threadIdx.x; v < run; v += COL_THREADS) {
                const int cz = v / C, ch = v - cz * C;  // (column, z) and channel
                from_f(out[v], src[(cz / Z * COL_ZB + cz % Z) * CL + ch]);
              }
            }
          }
        } else if (mine && c < C) {
          const float* acc = s_acc + col * COL_ZB * CL + lane;
          T* out = d_table + ((key0 + (int64_t)x * Y + y) * Z + zb) * C + c;
          for (int i = 0; i < COL_ZB && zb + i < Z; ++i) from_f(out[(int64_t)i * C], acc[i * CL]);
        }
        __syncthreads();  // s_acc is read before the next pass zeroes it
      }
    }
  }
}


// Plain C entry points, loaded with ctypes.  Pointers are device pointers;
// table [G, X, Y, Z, C], coords float32 [G, S, 3], out/gout [G, S, C].
// dtype: 0 = float32 table and out, 1 = bfloat16 table and out, 2 = uint8
// table and float32 out (forward only).  Each launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).

struct NarrowArgs {
  const void* table;
  const float* coords;
  void* out;
  int64_t n_pts;
  int S, X, Y, Z, C, align, border, lane_bits;
};

template <typename Tin, typename Tout, int VEC, int CPT, int PPL>
static void launch_narrow(const NarrowArgs& a, cudaStream_t st) {
  const int threads = 256;
  const int64_t n_groups = (a.n_pts + PPL - 1) / PPL;
  trilerp_fwd_narrow_kernel<Tin, Tout, VEC, CPT, PPL>
      <<<grid_blocks(n_groups << a.lane_bits, threads), threads, 0, st>>>(
          (const Tin*)a.table, a.coords, (Tout*)a.out, a.n_pts, a.S, a.X, a.Y,
          a.Z, a.C, a.align, a.border, a.lane_bits);
}

template <typename Tin, typename Tout, int VEC>
static void launch_narrow_cpt(const NarrowArgs& a, int cpt, cudaStream_t st) {
  if (cpt <= 1) launch_narrow<Tin, Tout, VEC, 1, 1>(a, st);
  else if (cpt == 2) launch_narrow<Tin, Tout, VEC, 2, 1>(a, st);
  else if (cpt == 3) launch_narrow<Tin, Tout, VEC, 3, 1>(a, st);
  else launch_narrow<Tin, Tout, VEC, 4, 1>(a, st);  // wider rows take passes of 4
}

template <typename Tin, typename Tout>
static int launch_narrow_typed(const NarrowArgs& a, int vec, int ppl,
                               cudaStream_t st) {
  if (a.C == 1) {  // vec == 1 and one lane (checked by the caller)
    if (ppl == 1) launch_narrow<Tin, Tout, 1, 1, 1>(a, st);
    else if (ppl == 2) launch_narrow<Tin, Tout, 1, 1, 2>(a, st);
    else launch_narrow<Tin, Tout, 1, 1, 4>(a, st);
    return (int)cudaGetLastError();
  }
  const int lanes = 1 << a.lane_bits;
  const int nchunk = a.C / vec;
  const int cpt = (nchunk + lanes - 1) / lanes;  // chunks a lane holds
  if (vec == 1) launch_narrow_cpt<Tin, Tout, 1>(a, cpt, st);
  else if (vec == 2) launch_narrow_cpt<Tin, Tout, 2>(a, cpt, st);
  else if (vec == 4) launch_narrow_cpt<Tin, Tout, 4>(a, cpt, st);
  else if constexpr (sizeof(Tin) == 2) launch_narrow_cpt<Tin, Tout, 8>(a, cpt, st);
  return (int)cudaGetLastError();
}

// The narrow-row forward, for any row: `vec` elements per load (1, 2 or 4,
// or 8 in bfloat16: at most 16 bytes loaded and 16 stored per chunk), C a
// multiple of vec, table and out aligned to a chunk; lanes (1, 2, 4, 8, 16
// or 32) per point; ppl points a lane at C = 1 (1, 2 or 4; then vec and
// lanes are 1), else 1.  One table's voxels below 2^31.  Returns
// cudaErrorInvalidValue for anything else.
extern "C" int trilerp_sample3d_fwd(const void* table, const void* coords,
                                    void* out, int G, int S, int X, int Y,
                                    int Z, int C, int align, int border,
                                    int dtype, int vec, int lanes, int ppl,
                                    void* stream) {
  const int in_size = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  const int out_size = dtype == 1 ? 2 : 4;
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  const bool vec_ok = vec == 1 || vec == 2 || vec == 4 || (vec == 8 && dtype == 1);
  if (dtype < 0 || dtype > 2 || !vec_ok || C <= 0 || C % vec != 0 ||
      (1 << lane_bits) != lanes || lanes > 32 ||
      (C == 1 ? (vec != 1 || lanes != 1 || (ppl != 1 && ppl != 2 && ppl != 4))
              : ppl != 1) ||
      (int64_t)X * Y * Z >= ((int64_t)1 << 31) ||
      (uintptr_t)table % (vec * in_size) != 0 ||
      (uintptr_t)out % (vec * out_size) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_pts = (int64_t)G * S;
  if (n_pts == 0) return 0;
  const NarrowArgs a{table, (const float*)coords, out, n_pts, S, X, Y, Z,
                     C, align, border, lane_bits};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_narrow_typed<float, float>(a, vec, ppl, st);
  if (dtype == 1)
    return launch_narrow_typed<__nv_bfloat16, __nv_bfloat16>(a, vec, ppl, st);
  return launch_narrow_typed<uint8_t, float>(a, vec, ppl, st);
}

// The row-wide forward.  table and out 16-byte aligned, C a multiple of
// 8 (bfloat16, dtype 1) or 4 (float32, dtype 0), X*Y*Z*C below 2^31;
// lanes (1, 2, 4, 8, 16 or 32) per point.  Returns cudaErrorInvalidValue
// for anything else.
template <typename T, int VPT>
static void launch_fwd_rows(const void* table, const void* coords, void* out,
                            int64_t n_pts, int S, int X, int Y, int Z, int C,
                            int align, int border, int lane_bits,
                            cudaStream_t st) {
  const int threads = 256;
  trilerp_fwd_rows_kernel<T, VPT>
      <<<grid_blocks(n_pts << lane_bits, threads), threads, 0, st>>>(
          (const T*)table, (const float*)coords, (T*)out, n_pts, S, X, Y, Z,
          C, align, border, lane_bits);
}

template <typename T>
static int launch_fwd_rows_vpt(const void* table, const void* coords,
                               void* out, int64_t n_pts, int S, int X, int Y,
                               int Z, int C, int align, int border,
                               int lane_bits, cudaStream_t st) {
  const int nvec = C / Vec16<T>::N;
  const int lanes = 1 << lane_bits;
  const int vpt = (nvec + lanes - 1) / lanes;  // vectors a lane holds
  if (vpt <= 1)
    launch_fwd_rows<T, 1>(table, coords, out, n_pts, S, X, Y, Z, C, align,
                          border, lane_bits, st);
  else if (vpt == 2)
    launch_fwd_rows<T, 2>(table, coords, out, n_pts, S, X, Y, Z, C, align,
                          border, lane_bits, st);
  else if (vpt == 3)
    launch_fwd_rows<T, 3>(table, coords, out, n_pts, S, X, Y, Z, C, align,
                          border, lane_bits, st);
  else  // wider rows take passes of 4
    launch_fwd_rows<T, 4>(table, coords, out, n_pts, S, X, Y, Z, C, align,
                          border, lane_bits, st);
  return (int)cudaGetLastError();
}

extern "C" int trilerp_sample3d_fwd_rows(const void* table, const void* coords,
                                         void* out, int G, int S, int X, int Y,
                                         int Z, int C, int align, int border,
                                         int dtype, int lanes, void* stream) {
  const int n = dtype == 1 ? 8 : 4;
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  if ((dtype != 0 && dtype != 1) || C <= 0 || C % n != 0 ||
      (1 << lane_bits) != lanes || lanes > 32 ||
      (int64_t)X * Y * Z * C >= ((int64_t)1 << 31) ||
      ((uintptr_t)table | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_pts = (int64_t)G * S;
  if (n_pts == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_fwd_rows_vpt<__nv_bfloat16>(table, coords, out, n_pts, S, X,
                                              Y, Z, C, align, border,
                                              lane_bits, st);
  return launch_fwd_rows_vpt<float>(table, coords, out, n_pts, S, X, Y, Z, C,
                                    align, border, lane_bits, st);
}

template <typename T>
static void launch_bwd_coords(const void* table, const void* coords, const void* gout,
                              void* d_coords, int64_t n_pts, int S, int X, int Y, int Z,
                              int C, int align, int border, cudaStream_t st) {
  const int threads = 256;
  const int64_t n_out = n_pts * C;
  trilerp_bwd_coords_kernel<T><<<grid_blocks(n_out, threads), threads, 0, st>>>(
      (const T*)table, (const float*)coords, (const T*)gout, (float*)d_coords, n_out, S, X,
      Y, Z, C, align, border);
}

template <typename T, int CLMAX>
static void launch_tiles_cl(const float* xyz, const void* gout, const int* offs,
                            const int* sorted, void* d_table, unsigned blocks, int smem, int G,
                            int X, int Y, int Z, int C, int align, int border, int lane_bits,
                            int TY, cudaStream_t st) {
  // above 48 KB (C of 25-32 channels) only as opted-in dynamic shared memory
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(trilerp_bwd_tiles_kernel<T, CLMAX>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  trilerp_bwd_tiles_kernel<T, CLMAX><<<blocks, COL_THREADS, smem, st>>>(
      xyz, (const T*)gout, offs, sorted, (T*)d_table, G, X, Y, Z, C, align, border, lane_bits,
      TY);
}

template <typename T>
static void launch_tiles(const float* xyz, const void* gout, const int* offs, const int* sorted,
                         void* d_table, unsigned blocks, int smem, int G, int X, int Y, int Z,
                         int C, int align, int border, int lane_bits, int TY, int CL,
                         cudaStream_t st) {
  if (CL == 1)
    launch_tiles_cl<T, 1>(xyz, gout, offs, sorted, d_table, blocks, smem, G, X, Y, Z, C, align,
                          border, lane_bits, TY, st);
  else if (CL <= 8)
    launch_tiles_cl<T, 8>(xyz, gout, offs, sorted, d_table, blocks, smem, G, X, Y, Z, C, align,
                          border, lane_bits, TY, st);
  else
    launch_tiles_cl<T, 32>(xyz, gout, offs, sorted, d_table, blocks, smem, G, X, Y, Z, C,
                           align, border, lane_bits, TY, st);
}

// Int32s of the narrow path's workspace: segment_sort over the G*X*Y
// columns with one int entry per point.
extern "C" long long trilerp_sample3d_bwd_workspace(int G, int S, int X, int Y) {
  return (long long)segment_sort_ints((int64_t)G * X * Y, (int64_t)G * S, 1);
}

// The narrow-row backward (any C).  d_table [G, X, Y, Z, C] in the table's
// dtype (0 float32, 1 bfloat16) is written in full; d_coords float32
// [G, S, 3] ZEROED by the caller, or NULL when no coordinate gradient is
// wanted (the table is then never read).  lanes (1, 2, 4, 8, 16 or 32) per
// column; `workspace` holds trilerp_sample3d_bwd_workspace(G, S, X, Y)
// int32s, 8-byte aligned; the columns (G*X*Y + 1) and points (G*S) below
// 2^31.  Returns cudaErrorInvalidValue for anything else.
extern "C" int trilerp_sample3d_bwd(const void* table, const void* coords,
                                    const void* gout, void* d_table,
                                    void* d_coords, void* workspace, int G, int S,
                                    int X, int Y, int Z, int C, int align, int border,
                                    int dtype, int lanes, void* stream) {
  const int64_t n_cols = (int64_t)G * X * Y;
  const int64_t n_pts = (int64_t)G * S;
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  if ((dtype != 0 && dtype != 1) || (1 << lane_bits) != lanes || lanes > 32 ||
      n_cols + 1 >= ((int64_t)1 << 31) || n_pts >= ((int64_t)1 << 31) ||
      (uintptr_t)workspace % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_cols == 0 || Z == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xyz = (const float*)coords;
  const auto s = segment_sort_space<int>(workspace, n_cols, n_pts);
  cudaError_t err =
      segment_sort(ColumnKeys{xyz, S, X, Y, Z, align, border}, n_pts, n_cols, s, st);
  if (err != cudaSuccess) return (int)err;
  // tiles of TY consecutive y (at most 32) by TX x
  const int cols = COL_THREADS >> lane_bits;
  const int TY = cols < 32 ? cols : 32;
  const int TX = cols / TY;
  const int64_t n_tiles = (int64_t)G * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY);
  const unsigned blocks = (unsigned)(n_tiles < ((int64_t)1 << 30) ? n_tiles : (int64_t)1 << 30);
  const int CL = C < lanes ? C : lanes;
  const int smem = ((COL_THREADS >> lane_bits) * COL_ZB * CL + COL_STAGE * (3 + 6 + CL)) *
                   (int)sizeof(float);
  if (dtype == 1)
    launch_tiles<__nv_bfloat16>(xyz, gout, s.offs, s.sorted, d_table, blocks, smem, G, X, Y, Z,
                                C, align, border, lane_bits, TY, CL, st);
  else
    launch_tiles<float>(xyz, gout, s.offs, s.sorted, d_table, blocks, smem, G, X, Y, Z, C,
                        align, border, lane_bits, TY, CL, st);
  if (d_coords != nullptr && n_pts > 0) {
    if (dtype == 1)
      launch_bwd_coords<__nv_bfloat16>(table, coords, gout, d_coords, n_pts, S, X, Y, Z, C,
                                       align, border, st);
    else
      launch_bwd_coords<float>(table, coords, gout, d_coords, n_pts, S, X, Y, Z, C, align,
                               border, st);
  }
  return (int)cudaGetLastError();
}

// Int32s of the wide path's workspace: segment_sort over the R = G*X*Y*Z
// rows with up to 8 int entries per point.
extern "C" long long trilerp_sample3d_bwd_seg_workspace(int G, int S, int X,
                                                        int Y, int Z) {
  return (long long)segment_sort_ints((int64_t)G * X * Y * Z, 8 * (int64_t)G * S, 1);
}

// The wide-row backward.  d_table [G, X, Y, Z, C] in the table's dtype is
// written in full (no zeroing needed); d_coords as in trilerp_sample3d_bwd
// (ZEROED) or NULL.  C must be a multiple of 8, the points' entries
// (8 * G * S) and the rows must fit in int32, and `workspace` must hold
// trilerp_sample3d_bwd_seg_workspace(G, S, X, Y, Z) int32s.
extern "C" int trilerp_sample3d_bwd_seg(const void* table, const void* coords,
                                        const void* gout, void* d_table,
                                        void* d_coords, void* workspace, int G,
                                        int S, int X, int Y, int Z, int C,
                                        int align, int border, int dtype,
                                        void* stream) {
  const int64_t R = (int64_t)G * X * Y * Z;
  const int64_t n_pts = (int64_t)G * S;
  if ((dtype != 0 && dtype != 1) || C % 8 != 0 || R >= ((int64_t)1 << 31) ||
      8 * n_pts >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xyz = (const float*)coords;
  const auto s = segment_sort_space<int>(workspace, R, 8 * n_pts);
  cudaError_t err =
      segment_sort(CornerKeys{xyz, S, X, Y, Z, align, border}, n_pts, R, s, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int64_t n_work = R * (C / 8);
  if (dtype == 1) {
    trilerp_bwd_gather_kernel<__nv_bfloat16><<<grid_blocks(n_work, threads), threads, 0, st>>>(
        xyz, (const __nv_bfloat16*)gout, s.offs, s.sorted, (__nv_bfloat16*)d_table,
        n_work, X, Y, Z, C, align, border);
    if (d_coords != nullptr && n_pts > 0)
      launch_bwd_coords<__nv_bfloat16>(table, coords, gout, d_coords, n_pts, S, X, Y, Z, C,
                                       align, border, st);
  } else {
    trilerp_bwd_gather_kernel<float><<<grid_blocks(n_work, threads), threads, 0, st>>>(
        xyz, (const float*)gout, s.offs, s.sorted, (float*)d_table, n_work, X, Y, Z,
        C, align, border);
    if (d_coords != nullptr && n_pts > 0)
      launch_bwd_coords<float>(table, coords, gout, d_coords, n_pts, S, X, Y, Z, C, align,
                               border, st);
  }
  return (int)cudaGetLastError();
}
