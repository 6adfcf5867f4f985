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
// Forward, two paths; ops/trilerp.py:fwd_path picks one by the row.
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
// * Scalar (trilerp_fwd_kernel): everything else (the uint8 GT masks, the
//   batched route's float32 C = 17 and C = 1 volumes and bf16 C = 100
//   match volumes): one thread per output (g, s, c), c fastest, so that a
//   warp reads neighbouring channels of the same corner.
// fwd_path sets no width threshold beyond whole vectors, from
// tools/time_backwards.py --sweep: both paths at the candidate readout's
// shape (bf16 [1, 128, 128, 16, C], 150528 points, border) on an H100 80GB
// HBM3 at 700 W, two sweeps in two calls, ms scalar / row-wide: C = 8
// 0.041-0.055 / 0.034-0.054, 16 0.057-0.072 / 0.052-0.056, 32 0.093-0.109 /
// 0.047-0.061, 48 0.132-0.154 / 0.061-0.078, 64 0.172-0.183 / 0.066-0.067,
// 128 0.354-0.364 / 0.130-0.140, 192 0.513-0.524 / 0.213-0.224; the
// row-wide path wins or ties at every width.  Lanes per point at C = 192:
// 1 0.266-0.300, 2 0.225-0.247, 4 0.216-0.240, 8 0.202-0.232, 16
// 0.196-0.226, 32 0.198-0.226 ms: more loads in flight per warp help up to
// a group that holds the row at 3 vectors a lane (row_lanes' choice, 8);
// 16 lanes were 2-7% faster again in both sweeps.
//
// Backward, two paths; ops/trilerp.py:bwd_path picks one by the row width C.
// The threshold, SEGMENTED_MIN_C = 48, comes from tools/time_backwards.py
// --sweep: both paths at the candidate readout's shape (bf16 [1, 128, 128,
// 16, C], 150528 points, border) on an H100 80GB HBM3 at 700 W, ms narrow /
// segmented: C = 8 0.07-0.14 / 0.21-0.23, 32 0.18 / 0.21-0.22, 40 0.20-0.21
// / 0.23-0.24, 48 0.23-0.27 / 0.25-0.26, 56 0.30-0.31 / 0.26, 64 0.31-0.34
// / 0.24, 192 1.01-1.03 / 0.35-0.36.  The narrow path's time grows with C (one
// atomic per channel), the segmented one's mostly with the points (its
// count, fill and rank passes do not depend on C); they cross near C = 48.
//
// * Wide rows (C a multiple of 8 and at least SEGMENTED_MIN_C; the
//   per-layer loss route's C = 192 feature): a per-voxel segmented
//   gather that writes every d_table row once, in the table's dtype, with no
//   float atomics and no float32 buffer.
//     1. count: one thread per point computes its 8 corners (make_axis, the
//        same in-range test as the forward) and adds 1 to an int32 histogram
//        over the G*X*Y*Z rows for each corner inside the table;
//     2. offsets: an exclusive scan of the histogram (a block scan of 4096
//        entries per block, a one-block scan of the block sums, an add pass);
//     3. fill: each (point, corner) entry takes a slot of its row's segment
//        through an int32 cursor (atomics, so the order is arbitrary);
//     4. rank: each entry counts the entries of its segment with a smaller
//        point index and moves to that rank, so every segment is in
//        ascending point order (the same order on every call);
//     5. gather: one thread per (row, 8-channel chunk), C/8 threads per row
//        (24 at C = 192), walks its segment in that order, recomputes the
//        corner weight from the point's coordinates, adds w * gout[point,
//        chunk] in float32 registers from 16-byte loads and stores the chunk
//        once; a row without entries gets zeros.
//   Two calls give bit-identical d_tables.  The int32 workspace (histogram,
//   cursor, block sums, two entry arrays: about 4 * (2 * G*X*Y*Z + 16 * G*S)
//   bytes) is allocated by the wrapper.
// * Narrow rows (everything else: the batched loss route's C = 17 and C = 1
//   per-slot volumes, G up to 170): one thread per (g, s, c) with float32
//   atomics into a zeroed [G, X*Y*Z, C] d_table (what the Pallas VJP returns
//   before its cast to the table's dtype), cast by the wrapper.  A 4-68 byte
//   row gains nothing from a row-wide gather, and the histogram would span
//   up to 44.6 M rows.
// Coordinate gradients (asked for by no loss readout; by the tests and the
// smoke run's float32 case) stay on the atomic kernel on both paths: each
// (g, s, c) thread adds its channel's share of the three derivatives into a
// zeroed [G, S, 3] buffer; on the wide path that kernel runs with no
// d_table and reads the table, which only the coordinate gradient needs.
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
// read-modify-write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

template <typename Tin, typename Tout>
__global__ void trilerp_fwd_kernel(const Tin* __restrict__ table,
                                   const float* __restrict__ coords,
                                   Tout* __restrict__ out, int64_t n_out,
                                   int S, int X, int Y, int Z, int C,
                                   int align, int border) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t vol = (int64_t)X * Y * Z * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const int c = (int)(i % C);
    const int64_t gs = i / C;  // g * S + s
    const int64_t g = gs / S;
    const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
    const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
    const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
    const Tin* base = table + g * vol + c;
    float acc = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = ax.i0 + dx;
      if (xi < 0 || xi >= X) continue;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yi = ay.i0 + dy;
        if (yi < 0 || yi >= Y) continue;
        const float wxy = ax.w[dx] * ay.w[dy];
        const int64_t row = ((int64_t)xi * Y + yi) * Z;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const int zi = az.i0 + dz;
          if (zi < 0 || zi >= Z) continue;
          acc += wxy * az.w[dz] * load_f(base + (row + zi) * C);
        }
      }
    }
    store_f(out + i, acc);
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
    const Axis ax = make_axis(coords[gs * 3 + 0], X, align, border);
    const Axis ay = make_axis(coords[gs * 3 + 1], Y, align, border);
    const Axis az = make_axis(coords[gs * 3 + 2], Z, align, border);
    int row[8];  // the corner's first vector within its table, or -1 outside
    float w[8];
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
          row[q] = ok ? ((xi * Y + yi) * Z + zi) * nvec : -1;
        }
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
          r[q][k] = (row[q] >= 0 && v < nvec) ? __ldg(tb + row[q] + v)
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

// The narrow-row backward: float32 atomics into a zeroed d_table; with
// d_table NULL it computes d_coords alone (the wide path's coordinate
// gradient).
template <typename T>
__global__ void trilerp_bwd_kernel(const T* __restrict__ table,
                                   const float* __restrict__ coords,
                                   const T* __restrict__ gout,
                                   float* __restrict__ d_table,
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
          const int64_t off = off0 + (row + zi) * C;
          if (d_table != nullptr)
            atomicAdd(d_table + off, go * ax.w[dx] * ay.w[dy] * az.w[dz]);
          if (d_coords != nullptr) {
            const float v = load_f(table + off);
            sx += (dx ? v : -v) * ay.w[dy] * az.w[dz];
            sy += (dy ? v : -v) * ax.w[dx] * az.w[dz];
            sz += (dz ? v : -v) * ax.w[dx] * ay.w[dy];
          }
        }
      }
    }
    if (d_coords != nullptr) {
      if (ax.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 0, go * sx * ax.dpix);
      if (ay.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 1, go * sy * ay.dpix);
      if (az.dpix != 0.f) atomicAdd(d_coords + gs * 3 + 2, go * sz * az.dpix);
    }
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

// 1. count: hist[row] += 1 for every in-range corner
__global__ void seg_count_kernel(const float* __restrict__ coords,
                                 int* __restrict__ hist, int64_t n_pts, int S,
                                 int X, int Y, int Z, int align, int border) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t gs = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; gs < n_pts;
       gs += stride)
    each_corner(coords, gs, S, X, Y, Z, align, border,
                [&](int64_t row) { atomicAdd(hist + row, 1); });
}

// 2. offsets: an exclusive scan, hand-written (no library kernel): a block
// scan of SCAN_TILE entries per block, a one-block scan of the block sums,
// and a pass that adds each tile's offset
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// Exclusive scan of one int per thread over the block (blockDim.x ==
// SCAN_THREADS); *total receives the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sums[lane];  // SCAN_THREADS / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sums[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int prefix = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[SCAN_THREADS / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return prefix;
}

// In place: each SCAN_TILE-entry tile of data[0, n) becomes its exclusive
// scan; tile_sums[tile] = the tile's sum.
__global__ void scan_tiles_kernel(int* __restrict__ data, int64_t n,
                                  int* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = base + k < n ? data[base + k] : 0;
    sum += v[k];
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < n) data[base + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: in-place exclusive scan of sums[0, n), a tile at a time.
__global__ void scan_sums_kernel(int* __restrict__ sums, int64_t n) {
  int carry = 0;
  for (int64_t start = 0; start < n; start += SCAN_TILE) {
    const int64_t base = start + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = base + k < n ? sums[base + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (base + k < n) sums[base + k] = run;
      run += v[k];
    }
    carry += total;
  }
}

__global__ void add_tile_offsets_kernel(int* __restrict__ data, int64_t n,
                                        const int* __restrict__ tile_sums) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    data[i] += tile_sums[i / SCAN_TILE];
}

static int64_t scan_tile_count(int64_t n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

// In place: data[0, n) becomes its exclusive scan; tile_sums holds
// scan_tile_count(n) ints of scratch.  Launches on `st`.
static void exclusive_scan(int* data, int64_t n, int* tile_sums, cudaStream_t st) {
  const int64_t tiles = scan_tile_count(n);
  if (tiles == 0) return;
  scan_tiles_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, st>>>(data, n, tile_sums);
  scan_sums_kernel<<<1, SCAN_THREADS, 0, st>>>(tile_sums, tiles);
  int64_t blocks = (n + 255) / 256;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  add_tile_offsets_kernel<<<(unsigned)blocks, 256, 0, st>>>(data, n, tile_sums);
}

// 3. fill: each entry (the point's index g*S + s) takes a slot of its row
__global__ void seg_fill_kernel(const float* __restrict__ coords,
                                int* __restrict__ cursor, int* __restrict__ ent,
                                int64_t n_pts, int S, int X, int Y, int Z,
                                int align, int border) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t gs = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; gs < n_pts;
       gs += stride)
    each_corner(coords, gs, S, X, Y, Z, align, border,
                [&](int64_t row) { ent[atomicAdd(cursor + row, 1)] = (int)gs; });
}

// 4. rank: every segment in ascending point order (a point has at most one
// entry per row, so the ranks within a segment are distinct)
__global__ void seg_rank_kernel(const float* __restrict__ coords,
                                const int* __restrict__ offs,
                                const int* __restrict__ ent,
                                int* __restrict__ sorted, int64_t n_pts, int S,
                                int X, int Y, int Z, int align, int border) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t gs = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; gs < n_pts;
       gs += stride)
    each_corner(coords, gs, S, X, Y, Z, align, border, [&](int64_t row) {
      const int beg = offs[row], end = offs[row + 1];
      int rank = 0;
      for (int j = beg; j < end; ++j) rank += ent[j] < (int)gs;
      sorted[beg + rank] = (int)gs;
    });
}

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

static unsigned grid_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return (unsigned)blocks;
}

// Plain C entry points, loaded with ctypes.  Pointers are device pointers;
// table [G, X, Y, Z, C], coords float32 [G, S, 3], out/gout [G, S, C].
// dtype: 0 = float32 table and out, 1 = bfloat16 table and out, 2 = uint8
// table and float32 out (forward only).  Each launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int trilerp_sample3d_fwd(const void* table, const void* coords,
                                    void* out, int G, int S, int X, int Y,
                                    int Z, int C, int align, int border,
                                    int dtype, void* stream) {
  const int64_t n_out = (int64_t)G * S * C;
  if (n_out == 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_blocks(n_out, threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    trilerp_fwd_kernel<float, float><<<blocks, threads, 0, st>>>(
        (const float*)table, (const float*)coords, (float*)out, n_out, S, X, Y,
        Z, C, align, border);
  } else if (dtype == 1) {
    trilerp_fwd_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)table, (const float*)coords,
        (__nv_bfloat16*)out, n_out, S, X, Y, Z, C, align, border);
  } else if (dtype == 2) {
    trilerp_fwd_kernel<uint8_t, float><<<blocks, threads, 0, st>>>(
        (const uint8_t*)table, (const float*)coords, (float*)out, n_out, S, X,
        Y, Z, C, align, border);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
static void launch_bwd_atomic(const void* table, const void* coords,
                              const void* gout, void* d_table, void* d_coords,
                              int64_t n_out, int S, int X, int Y, int Z, int C,
                              int align, int border, cudaStream_t st) {
  const int threads = 256;
  trilerp_bwd_kernel<T><<<grid_blocks(n_out, threads), threads, 0, st>>>(
      (const T*)table, (const float*)coords, (const T*)gout, (float*)d_table,
      (float*)d_coords, n_out, S, X, Y, Z, C, align, border);
}

// The narrow-row backward.  d_table float32 [G, X, Y, Z, C] ZEROED by the
// caller; d_coords float32 [G, S, 3] ZEROED by the caller, or NULL when no
// coordinate gradient is wanted (the table is then never read).  dtype 0 or
// 1 as above.
extern "C" int trilerp_sample3d_bwd(const void* table, const void* coords,
                                    const void* gout, void* d_table,
                                    void* d_coords, int G, int S, int X, int Y,
                                    int Z, int C, int align, int border,
                                    int dtype, void* stream) {
  const int64_t n_out = (int64_t)G * S * C;
  if (n_out == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_bwd_atomic<float>(table, coords, gout, d_table, d_coords, n_out, S,
                             X, Y, Z, C, align, border, st);
  } else if (dtype == 1) {
    launch_bwd_atomic<__nv_bfloat16>(table, coords, gout, d_table, d_coords,
                                     n_out, S, X, Y, Z, C, align, border, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Layout of the wide path's int32 workspace: offsets [R + 1], cursor [R],
// tile sums, entries [8 * G * S], sorted entries [8 * G * S], with R =
// G * X * Y * Z rows.

extern "C" long long trilerp_sample3d_bwd_seg_workspace(int G, int S, int X,
                                                        int Y, int Z) {
  const int64_t R = (int64_t)G * X * Y * Z;
  return (long long)(2 * R + 1 + scan_tile_count(R + 1) + 16 * (int64_t)G * S);
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
  int* offs = (int*)workspace;
  int* cursor = offs + R + 1;
  int* sums = cursor + R;
  int* ent = sums + scan_tile_count(R + 1);
  int* sorted = ent + 8 * n_pts;
  const float* xyz = (const float*)coords;
  const int threads = 256;
  cudaError_t err = cudaMemsetAsync(offs, 0, (R + 1) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_pts > 0)
    seg_count_kernel<<<grid_blocks(n_pts, threads), threads, 0, st>>>(
        xyz, offs, n_pts, S, X, Y, Z, align, border);
  exclusive_scan(offs, R + 1, sums, st);
  if (n_pts > 0) {
    err = cudaMemcpyAsync(cursor, offs, R * sizeof(int), cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    seg_fill_kernel<<<grid_blocks(n_pts, threads), threads, 0, st>>>(
        xyz, cursor, ent, n_pts, S, X, Y, Z, align, border);
    seg_rank_kernel<<<grid_blocks(n_pts, threads), threads, 0, st>>>(
        xyz, offs, ent, sorted, n_pts, S, X, Y, Z, align, border);
  }
  const int64_t n_work = R * (C / 8);
  if (dtype == 1) {
    trilerp_bwd_gather_kernel<__nv_bfloat16><<<grid_blocks(n_work, threads), threads, 0, st>>>(
        xyz, (const __nv_bfloat16*)gout, offs, sorted, (__nv_bfloat16*)d_table,
        n_work, X, Y, Z, C, align, border);
    if (d_coords != nullptr && n_pts > 0)
      launch_bwd_atomic<__nv_bfloat16>(table, coords, gout, nullptr, d_coords,
                                       n_pts * C, S, X, Y, Z, C, align, border, st);
  } else {
    trilerp_bwd_gather_kernel<float><<<grid_blocks(n_work, threads), threads, 0, st>>>(
        xyz, (const float*)gout, offs, sorted, (float*)d_table, n_work, X, Y, Z,
        C, align, border);
    if (d_coords != nullptr && n_pts > 0)
      launch_bwd_atomic<float>(table, coords, gout, nullptr, d_coords, n_pts * C,
                               S, X, Y, Z, C, align, border, st);
  }
  return (int)cudaGetLastError();
}
