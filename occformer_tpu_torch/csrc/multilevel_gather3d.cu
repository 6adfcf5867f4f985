// Unweighted multi-level trilinear gather over 3D pyramids (K4) and its
// backward (K4-bwd).
//
// Replaces the TPU kernels occformer_tpu/ops/trilerp_fused.py:_build_op.
// call_fwd (:492, body _fwd_kernel :126) and call_bwd (:508, body
// _bwd_kernel :172), public fused_multilevel_gather (:553): every pyramid
// level's trilinear samples in one launch,
//
//   out_l[g, c, s] = sum over the 8 corners of corner_weight *
//                    table_l[g, corner, c]
//
// with table_l the channels-last [G, X_l, Y_l, Z_l, C] (the same memory as
// the JAX slab [G, X_l*Y_l, Z_l*C]), coords_l [G, S_l, 3] in [-1, 1] as
// (x, y, z), and out_l channels-first [G, C, S_l] in the table's type.
// Unnormalization follows ops/sampling.py:_unnormalize for both
// align_corners; padding is zeros (a corner outside the level carries
// weight 0, make_meta_rows :70-81).  The sum is kept in float32 and rounded
// once to the table's type.
//
// One launch covers all levels, as the TPU kernel's one call does: the
// threads walk the levels' (g, s) ranges back to back, and a per-level
// descriptor (table, coords, output pointers, X, Y, Z, S and the level's
// first thread) is passed by value; each thread picks its level with an
// unrolled compare over the descriptors, so no level field is indexed
// dynamically.  The TPU kernel's row concatenation, lane padding to Zmax*C,
// one-hot matmuls, windows and escape passes exist because the TPU gathers
// badly; here each thread gathers directly.
//
// Thread mapping: one thread per (g, sample), so that the writes of the
// channels-first output are coalesced along s (a warp's store of one
// channel is 32 neighbouring samples: 64 bytes in bf16, 128 in float32).
// The forward is one row-wide kernel (multilevel_fwd_rows_kernel) for every
// row: each thread reads its 8 corner rows as vectors, VPT of a row a pass
// (48 bytes: a whole bf16 row of C = 24, half a float32 one; at most 12
// vectors), issues all 8 x VPT loads of a pass before any FMA, sums its
// channels in float32 registers and stores them channels-first.  A corner
// outside the level, and a vector past the row's end, is not loaded (it
// adds zeros to a sum that is not stored).  The vector width is the widest
// of 16, 8, 4 and 2 bytes that divides the row's bytes and every table's
// address (ops/trilerp_fused.py:multi_fwd_path): the deformable attention's
// C = 24 takes 16 bytes in bf16 and float32, C = 12 in bf16 and C = 6 in
// float32 8.  A misaligned table is copied once to an aligned buffer by
// the launcher, not read with the narrower vector its address allows: at
// the deformable attention's shapes, bf16 C = 24 tables 4 bytes past a
// 16-byte boundary took 0.456 device ms with 4-byte vectors and 0.294 with
// the copies and 16-byte vectors (time_backwards.py K4.other, H100 80GB
// HBM3, 700 W).  A shared-memory transpose tile for wider stores was not
// needed: the stores are already 64-byte runs.
// The first design's per-channel loop issued one scalar 2-byte load per
// corner and channel, 192 dependent-address loads a thread at C = 24, each
// touching 32 rows across the warp: 1.79 ms at the flagship shapes, 2.3x
// slower than three F.grid_sample calls.  It took every row but the
// 16-byte ones (C = 6 in float32, C = 12 in bf16, a misaligned table).
// The backward (K4-bwd) writes every output once in the table's or float32
// dtype, with no float atomics, so two calls give the same bits:
// * d_tables through ordered_rows.cuh, as K1-bwd's d_value
//   (ms_deform_gather3d.cu): every (level, g, sample) with a corner inside
//   its level is binned once by its lower corner, as an entry (item, w1x,
//   w1y, w1z), each bin's entries ordered by item; a thread per (d_table
//   row, chunk) walks the row's 8 neighbour bins in corner order, each in
//   ascending item order, adds corner_weight * gout[item, :] in float32 and
//   stores the row once in the table's dtype (rows no sample touches as
//   zeros).  The gather reads gout as rows [sum_l G * S_l, C], which the
//   wrapper makes from the channels-first [G, C, S_l] with one transpose
//   copy per level; the levels' d_tables are one buffer.
// * d_coords, when the caller asks for it (multilevel_bwd_coords_kernel): a
//   thread per sample sums the 8 dots gout . table[corner] from the rows'
//   chunks (16 bytes where C and the pointers allow), CPP chunks of all 8
//   corners loaded before their FMAs, and stores its three slopes with a
//   plain store.  As in _bwd_kernel (:214-216), d_coords carries the
//   derivative through the corner weights only; floor and the validity
//   masks carry none.
// The design before this one ran a thread per (g, sample) that added
// go * corner_weight into a zeroed float32 d_table with one scalar atomic
// per (corner, channel), 689 M at the flagship's shapes, and cast it: 10.5
// ms, 0.8% of its bound, and sums that changed from run to run.

// Bounds on an H100 SXM at the deformable attention's shapes (levels
// (64,64,8), (32,32,4), (16,16,2), G = 8, C = 24, S_l = 149504, bf16
// tables): both are memory-bound.  Forward: tables 14.35 MB + coords
// 43.06 MB read, out 172.23 MB written, about 230 MB, about 69 us at
// 3.35 TB/s; the corner reads hit L2 (the tables are 14 MB), but they are
// 8 rows of 48 bytes a sample, 1.38 GB of L2 traffic in all, which sets
// the row-wide path's pace.
// Backward: the same reads with gout in place of out, d_tables in the
// table's type and d_coords written, about 287 MB, about 86 us; this
// fixed order adds its binning (3.6 M entries of 16 bytes written, sorted
// and read 8 times, once per corner), the 172 MB gout transpose, and each
// term's 48-byte gout row read from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ordered_rows.cuh"

#define MAX_LEVELS 8

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Level {
  const void* table;   // [G, X, Y, Z, C]
  const float* coords; // [G, S, 3]
  void* out;           // forward: [G, C, S]
  float* d_coords;     // backward: float32 [G, S, 3], or NULL
  int64_t start;       // first thread (item) of the level: G * sum of earlier S
  int64_t row_start;   // first d_table row of the level: G * sum of earlier X * Y * Z
  int64_t bin_start;   // K4-bwd's first lower-corner bin of the level (ordered_rows.cuh):
                       // G * sum of earlier (X + 1) * (Y + 1) * (Z + 1)
  int X, Y, Z, S;
};

struct Levels {
  Level l[MAX_LEVELS];
  int n;
};

__device__ __forceinline__ Level pick(const Levels& lv, int64_t i) {
  Level L = lv.l[0];
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k < lv.n && i >= lv.l[k].start) L = lv.l[k];
  return L;
}

struct Axis {
  int i0;      // lower corner index (may lie outside [0, size))
  float w[2];  // lerp weights of the lower and upper corner
  bool ok[2];  // the corner lies inside [0, size)
  float dpix;  // d pix / d coord
};

__device__ __forceinline__ Axis make_axis(float coord, int size, int align) {
  float pix, dpix;
  if (align) {
    pix = (coord + 1.f) * 0.5f * (float)(size - 1);
    dpix = 0.5f * (float)(size - 1);
  } else {
    pix = ((coord + 1.f) * (float)size - 1.f) * 0.5f;
    dpix = 0.5f * (float)size;
  }
  // keeps the float-to-int conversion defined; a clamped position has
  // every corner outside the level, as the unclamped one has
  pix = fminf(fmaxf(pix, -2.f), (float)size + 1.f);
  Axis a;
  const float f = floorf(pix);
  a.i0 = (int)f;
  a.w[1] = pix - f;
  a.w[0] = 1.f - a.w[1];
  a.ok[0] = a.i0 >= 0 && a.i0 < size;
  a.ok[1] = a.i0 + 1 >= 0 && a.i0 + 1 < size;
  a.dpix = dpix;
  return a;
}

// The 8 corners of one sample: element offsets into the level's [X, Y, Z, C]
// table of one g (channel 0), weights, and whether each lies inside.
struct Corners {
  int64_t off[8];
  float w[8];
  bool ok[8];
};

__device__ __forceinline__ Corners make_corners(const Axis& ax, const Axis& ay,
                                                const Axis& az, int Y, int Z,
                                                int C) {
  Corners k;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int j = dx * 4 + dy * 2 + dz;
        k.ok[j] = ax.ok[dx] && ay.ok[dy] && az.ok[dz];
        k.w[j] = k.ok[j] ? ax.w[dx] * ay.w[dy] * az.w[dz] : 0.f;
        k.off[j] = k.ok[j] ? (((int64_t)(ax.i0 + dx) * Y + (ay.i0 + dy)) * Z +
                              (az.i0 + dz)) * C
                           : 0;
      }
  return k;
}

// ---- the row-wide forward: each corner row read as vectors ----

// One thread per (level, g, sample); each corner row is read as vectors of
// VB bytes (N = VB / sizeof(T) channels): a pass takes VPT vectors (VPT * N
// channels) of all 8 corners, issues those 8 * VPT loads before any FMA,
// sums in float32 registers and stores its channels; the channels-first
// stores of a warp are runs of 32 neighbouring samples along s.  A corner
// outside the level, and a vector past the row's end, is not loaded (it
// adds zeros to a sum that is not stored).
template <typename T, int VB, int VPT>
__global__ void __launch_bounds__(256)
multilevel_fwd_rows_kernel(const Levels lv, int64_t n, int C, int align) {
  using R = typename Raw<VB>::T;
  constexpr int N = VB / sizeof(T);
  const int nvec = C / N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Level L = pick(lv, i);
    const int64_t j = i - L.start;  // g * S + s
    const int64_t g = j / L.S;
    const int64_t s = j - g * L.S;
    const Axis ax = make_axis(L.coords[j * 3 + 0], L.X, align);
    const Axis ay = make_axis(L.coords[j * 3 + 1], L.Y, align);
    const Axis az = make_axis(L.coords[j * 3 + 2], L.Z, align);
    const Corners k = make_corners(ax, ay, az, L.Y, L.Z, C);
    const T* tb = (const T*)L.table + g * ((int64_t)L.X * L.Y * L.Z * C);
    T* out = (T*)L.out + g * C * (int64_t)L.S + s;
    for (int v0 = 0; v0 < nvec; v0 += VPT) {
      R r[8][VPT];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < VPT; ++u)
          r[q][u] = (k.ok[q] && v0 + u < nvec)
                        ? __ldg(reinterpret_cast<const R*>(tb + k.off[q]) + v0 + u)
                        : R{};
      float acc[VPT][N];
#pragma unroll
      for (int u = 0; u < VPT; ++u)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[u][e] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < VPT; ++u) fma_vec<T, VB>(acc[u], r[q][u], k.w[q]);
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        if (v0 + u >= nvec) break;
#pragma unroll
        for (int e = 0; e < N; ++e)
          store_f(out + (int64_t)((v0 + u) * N + e) * L.S, acc[u][e]);
      }
    }
  }
}

constexpr int BWD_CPP = 3;  // chunks of a row whose loads a sample issues together

// d_coords: thread i = (level, g, sample)
template <typename T, int VEC>
__global__ void __launch_bounds__(256) multilevel_bwd_coords_kernel(
    const Levels lv, const T* __restrict__ gout_rows, int64_t n, int C, int align) {
  using R = typename Raw<VEC * sizeof(T)>::T;
  const int nchunk = C / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Level L = pick(lv, i);
    const int64_t j = i - L.start;
    const int64_t g = j / L.S;
    const Axis ax = make_axis(L.coords[j * 3 + 0], L.X, align);
    const Axis ay = make_axis(L.coords[j * 3 + 1], L.Y, align);
    const Axis az = make_axis(L.coords[j * 3 + 2], L.Z, align);
    const Corners k = make_corners(ax, ay, az, L.Y, L.Z, C);
    const T* tb = (const T*)L.table + g * ((int64_t)L.X * L.Y * L.Z * C);
    const T* go = gout_rows + i * C;
    float gv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) gv[q] = 0.f;
    for (int c0 = 0; c0 < nchunk; c0 += BWD_CPP) {
      R graw[BWD_CPP], vraw[BWD_CPP][8];
#pragma unroll
      for (int u = 0; u < BWD_CPP; ++u) {
        const int c = c0 + u;
        graw[u] = c < nchunk ? *reinterpret_cast<const R*>(go + c * VEC) : R{};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          vraw[u][q] = (c < nchunk && k.ok[q])
                           ? __ldg(reinterpret_cast<const R*>(tb + k.off[q] + c * VEC))
                           : R{};
      }
#pragma unroll
      for (int u = 0; u < BWD_CPP; ++u) {
        float gf[VEC];
        chunk_floats<T, VEC>(gf, graw[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (!k.ok[q]) continue;
          float vf[VEC];
          chunk_floats<T, VEC>(vf, vraw[u][q]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) gv[q] = fmaf(gf[e], vf[e], gv[q]);
        }
      }
    }
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float v = gv[dx * 4 + dy * 2 + dz];
          sx += (dx ? v : -v) * ay.w[dy] * az.w[dz];
          sy += (dy ? v : -v) * ax.w[dx] * az.w[dz];
          sz += (dz ? v : -v) * ax.w[dx] * ay.w[dy];
        }
    L.d_coords[j * 3 + 0] = sx * ax.dpix;
    L.d_coords[j * 3 + 1] = sy * ay.dpix;
    L.d_coords[j * 3 + 2] = sz * az.dpix;
  }
}

// the bins of one g of a level: (X + 1) (Y + 1) (Z + 1) lower corners
__device__ __forceinline__ int64_t bins_per_g(const Level& L) {
  return (int64_t)(L.X + 1) * (L.Y + 1) * (L.Z + 1);
}

// d_tables' entries: item i = (level, g, sample), with a corner inside its
// level, binned by its lower corner, the entry (i, w1x, w1y, w1z)
struct K4Keys {
  using Entry = BinEntry;
  Levels lv;
  int align;
  template <class Fn>
  __device__ __forceinline__ void operator()(int64_t i, Fn fn) const {
    const Level L = pick(lv, i);
    const int64_t j = i - L.start;
    const int64_t g = j / L.S;
    const Axis ax = make_axis(L.coords[j * 3 + 0], L.X, align);
    const Axis ay = make_axis(L.coords[j * 3 + 1], L.Y, align);
    const Axis az = make_axis(L.coords[j * 3 + 2], L.Z, align);
    if (ax.i0 < -1 || ax.i0 >= L.X || ay.i0 < -1 || ay.i0 >= L.Y || az.i0 < -1 || az.i0 >= L.Z)
      return;
    fn(L.bin_start + g * bins_per_g(L) +
           ((int64_t)(ax.i0 + 1) * (L.Y + 1) + (ay.i0 + 1)) * (L.Z + 1) + (az.i0 + 1),
       BinEntry{(int)i, {ax.w[1], ay.w[1], az.w[1]}});
  }
};

// The level of d_table row r, and of bin k
__device__ __forceinline__ Level level_of_row(const Levels& lv, int64_t r) {
  Level L = lv.l[0];
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k < lv.n && r >= lv.l[k].row_start) L = lv.l[k];
  return L;
}
__device__ __forceinline__ Level level_of_bin(const Levels& lv, int64_t bin) {
  Level L = lv.l[0];
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k < lv.n && bin >= lv.l[k].bin_start) L = lv.l[k];
  return L;
}

// d_table row r = row_start + g * X * Y * Z + voxel: its 8 neighbour bins; a
// term's src row (the item's gout row) and weight (the corner weight)
struct K4Geo {
  static constexpr bool kScaled = false;
  Levels lv;
  __device__ __forceinline__ void bins(int64_t r, int64_t (&bn)[8]) const {
    const Level L = level_of_row(lv, r);
    const int64_t vol = (int64_t)L.X * L.Y * L.Z;
    const int64_t g = (r - L.row_start) / vol;
    const int v = (int)((r - L.row_start) % vol);
    const int z = v % L.Z, y = v / L.Z % L.Y, x = v / (L.Z * L.Y);
    const int64_t base = L.bin_start + g * bins_per_g(L);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      bn[q] = base + ((int64_t)(x - (q >> 2) + 1) * (L.Y + 1) + (y - ((q >> 1) & 1) + 1)) *
                         (L.Z + 1) + (z - (q & 1) + 1);
  }
  __device__ __forceinline__ int64_t src(int i) const { return i; }
  __device__ __forceinline__ float weight(float, float wx, float wy, float wz) const {
    return wx * wy * wz;
  }
};

// A heavy bin's candidates: the S samples of its (level, g)
struct K4Cand {
  Levels lv;
  __device__ __forceinline__ int64_t count(int64_t bin) const { return level_of_bin(lv, bin).S; }
  __device__ __forceinline__ int item(int64_t bin, int64_t t) const {
    const Level L = level_of_bin(lv, bin);
    return (int)(L.start + (bin - L.bin_start) / bins_per_g(L) * L.S + t);
  }
};

// Fills the descriptors; returns the thread count G * sum S_l (and, in
// *n_rows and *n_bins when given, the d_table rows G * sum X_l * Y_l * Z_l
// and K4-bwd's bins G * sum (X_l + 1) (Y_l + 1) (Z_l + 1)), or -1 when the
// level count is out of range.
static int64_t make_levels(Levels* lv, int L, const void* const* tables,
                           const void* const* coords, void* const* outs,
                           void* const* d_coords, const int* dims, int G,
                           int64_t* n_rows = nullptr, int64_t* n_bins = nullptr) {
  if (L < 1 || L > MAX_LEVELS) return -1;
  int64_t start = 0, row_start = 0, bin_start = 0;
  lv->n = L;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    Level& d = lv->l[l];
    if (l >= L) {  // unused slots never match: start past every thread
      d = lv->l[0];
      d.start = INT64_MAX;
      d.row_start = INT64_MAX;
      d.bin_start = INT64_MAX;
      continue;
    }
    d.table = tables ? tables[l] : nullptr;
    d.coords = (const float*)coords[l];
    d.out = outs ? outs[l] : nullptr;
    d.d_coords = d_coords ? (float*)d_coords[l] : nullptr;
    d.X = dims[4 * l + 0];
    d.Y = dims[4 * l + 1];
    d.Z = dims[4 * l + 2];
    d.S = dims[4 * l + 3];
    d.start = start;
    d.row_start = row_start;
    d.bin_start = bin_start;
    start += (int64_t)G * d.S;
    row_start += (int64_t)G * d.X * d.Y * d.Z;
    bin_start += (int64_t)G * (d.X + 1) * (d.Y + 1) * (d.Z + 1);
  }
  if (n_rows) *n_rows = row_start;
  if (n_bins) *n_bins = bin_start;
  return start;
}

template <typename T, int VB, int VPT>
static void launch_rows(const Levels& lv, int64_t n, int C, int align, cudaStream_t st) {
  const int threads = 256;
  multilevel_fwd_rows_kernel<T, VB, VPT><<<grid_blocks(n, threads), threads, 0, st>>>(
      lv, n, C, align);
}

// VPT for rows of nvec vectors of VB bytes: 16-byte vectors 3 (a pass of 48
// bytes); narrower ones the next of 1, 2, 3, 4, 6, 8, 12 at or above nvec,
// at most 48 bytes and 12 vectors a pass.
template <typename T, int VB>
static void launch_rows_vpt(const Levels& lv, int64_t n, int C, int align, cudaStream_t st) {
  constexpr int CAP = 48 / VB < 12 ? 48 / VB : 12;
  const int nvec = C / (VB / (int)sizeof(T));
  if constexpr (VB == 16) {
    launch_rows<T, VB, 3>(lv, n, C, align, st);
  } else {
    if (nvec <= 1) launch_rows<T, VB, 1>(lv, n, C, align, st);
    else if (nvec <= 2) launch_rows<T, VB, 2>(lv, n, C, align, st);
    else if (nvec <= 3) launch_rows<T, VB, 3>(lv, n, C, align, st);
    else if (nvec <= 4) launch_rows<T, VB, 4>(lv, n, C, align, st);
    else if (CAP == 6 || nvec <= 6) launch_rows<T, VB, 6>(lv, n, C, align, st);
    else if constexpr (CAP >= 12) {
      if (nvec <= 8) launch_rows<T, VB, 8>(lv, n, C, align, st);
      else launch_rows<T, VB, 12>(lv, n, C, align, st);
    }
  }
}

// Plain C entry points, loaded with ctypes.  Per level l (L of them, at
// most MAX_LEVELS): tables[l] a device pointer to [G, X, Y, Z, C], coords[l]
// to float32 [G, S, 3], outs[l] to [G, C, S]; dims[4 l .. 4 l + 3] = X, Y,
// Z, S.  dtype: 0 = float32 tables and outputs, 1 = bfloat16.  Each
// launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted), or cudaErrorInvalidValue for a bad level count or dtype.
//
// K4: the tables' rows read as vectors of `vec` bytes (16, 8, 4 or 2; at
// least one element) that divide C's bytes and every table's address;
// cudaErrorInvalidValue for any other width.
extern "C" int multilevel_gather3d_fwd_rows(int L, const void* const* tables,
                                            const void* const* coords,
                                            void* const* outs, const int* dims,
                                            int G, int C, int align, int dtype,
                                            int vec, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || C <= 0 ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2) || vec < esize || (C * esize) % vec != 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L && l < MAX_LEVELS; ++l)
    if ((uintptr_t)tables[l] % vec != 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  const int64_t n = make_levels(&lv, L, tables, coords, outs, nullptr, dims, G);
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vec == 16) launch_rows_vpt<float, 16>(lv, n, C, align, st);
    else if (vec == 8) launch_rows_vpt<float, 8>(lv, n, C, align, st);
    else launch_rows_vpt<float, 4>(lv, n, C, align, st);
  } else {
    using T = __nv_bfloat16;
    if (vec == 16) launch_rows_vpt<T, 16>(lv, n, C, align, st);
    else if (vec == 8) launch_rows_vpt<T, 8>(lv, n, C, align, st);
    else if (vec == 4) launch_rows_vpt<T, 4>(lv, n, C, align, st);
    else launch_rows_vpt<T, 2>(lv, n, C, align, st);
  }
  return (int)cudaGetLastError();
}

// K4-bwd's workspace: int32s for ordered_rows.cuh over the bins
// G * sum (X_l + 1) (Y_l + 1) (Z_l + 1) and one entry per (g, sample).
extern "C" long long multilevel_gather3d_bwd_workspace(int L, const int* dims, int G) {
  int64_t bins = 0, items = 0;
  for (int l = 0; l < L; ++l) {
    bins += (int64_t)G * (dims[4 * l] + 1) * (dims[4 * l + 1] + 1) * (dims[4 * l + 2] + 1);
    items += (int64_t)G * dims[4 * l + 3];
  }
  return (long long)ordered_rows_ints(bins, items);
}

// gout_rows [sum_l G * S_l, C] in the tables' type (level l's gout [G, C,
// S_l] as rows (g, s), the levels back to back); d_tables the levels'
// [G, X, Y, Z, C] back to back in the tables' type, written in full;
// d_coords NULL (no coordinate gradient: the tables are then never read) or
// d_coords[l] float32 [G, S, 3], every element written here; `workspace`
// holds multilevel_gather3d_bwd_workspace(L, dims, G) int32s, 16-byte
// aligned.  The bins (+ 1) and the items must lie below 2^31.
extern "C" int multilevel_gather3d_bwd(int L, const void* const* tables,
                                       const void* const* coords,
                                       const void* gout_rows, void* d_tables,
                                       void* const* d_coords, void* workspace,
                                       const int* dims, int G, int C, int align,
                                       int dtype, void* stream) {
  Levels lv;
  int64_t n_rows = 0, n_bins = 0;
  const int64_t n = make_levels(&lv, L, tables, coords, nullptr, d_coords, dims, G, &n_rows,
                                &n_bins);
  if (n < 0 || (dtype != 0 && dtype != 1) || n_bins + 1 >= ((int64_t)1 << 31) ||
      n >= ((int64_t)1 << 31) || (uintptr_t)workspace % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int esize = dtype == 1 ? 2 : 4;
  const void* ptrs[MAX_LEVELS + 2];
  for (int l = 0; l < L; ++l) ptrs[l] = tables[l];
  ptrs[L] = gout_rows;
  ptrs[L + 1] = d_tables;
  const int vec = row_chunk(C, esize, ptrs, L + 2);
  const OrderedRowsSpace s = ordered_rows_space(workspace, n_bins, n);
  const int threads = 256;
#define K4_BWD_COORDS(T, V)                                                    \
  multilevel_bwd_coords_kernel<T, V><<<grid_blocks(n, threads), threads, 0, st>>>( \
      lv, (const T*)gout_rows, n, C, align)
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (d_coords != nullptr && n > 0) {
      if (vec == 8) K4_BWD_COORDS(T, 8);
      else if (vec == 4) K4_BWD_COORDS(T, 4);
      else if (vec == 2) K4_BWD_COORDS(T, 2);
      else K4_BWD_COORDS(T, 1);
    }
    err = ordered_rows_sum<T>(K4Keys{lv, align}, n, K4Geo{lv}, K4Cand{lv}, n_bins, n_rows, C,
                              vec, (const T*)gout_rows, (T*)d_tables, s, st);
  } else {
    using T = float;
    if (d_coords != nullptr && n > 0) {
      if (vec == 4) K4_BWD_COORDS(T, 4);
      else if (vec == 2) K4_BWD_COORDS(T, 2);
      else K4_BWD_COORDS(T, 1);
    }
    err = ordered_rows_sum<T>(K4Keys{lv, align}, n, K4Geo{lv}, K4Cand{lv}, n_bins, n_rows, C,
                              vec, (const T*)gout_rows, (T*)d_tables, s, st);
  }
#undef K4_BWD_COORDS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
