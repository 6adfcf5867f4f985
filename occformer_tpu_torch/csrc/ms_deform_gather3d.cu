// Multi-scale deformable-attention gather over 3D voxel pyramids (K1) and
// its backward (K1-bwd, further below).
//
// Replaces the TPU kernel occformer_tpu/ops/trilerp_fused.py:_wfold_fwd_body
// (public fused_multilevel_weighted_gather, called from
// occformer_tpu/models/deform_attn.py once per encoder layer).  It computes,
// with the JAX module's layouts,
//
//   out[b, q, h, :] = sum_l sum_p  w[b, q, h, l, p] *
//                     trilerp_zeros(V_l[b, :, h, :], 2 * loc[b, q, h, l, p] - 1)
//
// value [B, Nv, H, hd] (the levels stacked on Nv, each flattened x-major:
// index (x * Y + y) * Z + z), loc [B, Nq, H, L, P, 3] float32 in [0, 1] as
// (x, y, z), w [B, Nq, H, L, P], out [B, Nq, H, hd].  Sampling follows
// F.grid_sample(align_corners=False, padding_mode="zeros"): a corner outside
// its level contributes zero.
//
// The one-hot matmuls, 16-row windows, escape pass and padded meta rows of
// the Pallas kernel exist only because the TPU gathers badly; here every
// thread gathers directly.  The forward has two paths;
// ops/trilerp_fused.py:ms_deform_fwd_path picks one by the row and the
// alignment of value and out:
// * Row-wide (ms_deform_gather3d_rows_kernel; rows of whole 16-byte
//   vectors at a 16-byte aligned value and out: the flagship's hd = 24 in
//   bf16 and float32).  The first design (below) ran one thread per output
//   channel: the 24 threads of a (b, q, h) each re-read its 36 location
//   floats and 12 weights, redid the 12 samples' unnormalize, floor and
//   corner weights, and loaded 2 bytes a corner, a warp straddling two
//   heads' rows; 1.25 ms bf16 at the flagship, 1.9% of its bound.  Here a
//   group of `lanes` lanes (ROW_LANES) takes one output row (b, q, h) and
//   its lanes own whole samples of the L x P: a lane reads a sample's
//   location and attention weight once, folds the weight into the 8 corner
//   weights, issues the 16-byte loads of all 8 corner rows (3 vectors a
//   bf16 row, 6 a float32 one, in batches of 3) before their FMAs and sums
//   in float32 registers; the group adds its lanes' sums with a fixed
//   shuffle butterfly (two calls give the same bits) and stores the row once
//   as 16-byte vectors.  Lanes per row x samples a lane loads at a time, from
//   occformer_tpu_torch/tools/time_backwards.py --sweep at the flagship's
//   shapes on an H100 80GB HBM3 at 700 W, ms bf16 uniform / local, float32
//   uniform / local locations: 1x1 0.410 / 0.234-0.248 / 0.794-0.822 /
//   0.406-0.411, 2x1 0.390-0.391 / 0.217-0.233 / 0.708-0.712 /
//   0.353-0.355, 4x1 0.397-0.398 / 0.234-0.239 / 0.709-0.710 / 0.413,
//   8x1 0.413-0.415 / 0.322-0.323 / 0.735-0.739 / 0.551-0.561, 16x1
//   0.414-0.415 / 0.370 / 0.741-0.746 / 0.635-0.653, 32x1 0.694 / 0.665-0.693
//   / 1.092 / 0.989-0.994; 2 samples at a time (1 vector a batch) tie at 1
//   lane on local locations and are 0.02-0.99 ms slower everywhere else, 3
//   slower again (the scalar path 1.24 / 1.07 / 1.47 / 1.10).  ROW_LANES =
//   2, one sample at a time.
// * Scalar (ms_deform_gather3d_kernel; any other row, e.g. hd = 12 in bf16,
//   or a misaligned value): the 3D analogue of Deformable-DETR's
//   ms_deform_attn im2col kernel, one thread per output element
//   (b, q, h, c), c fastest so that neighbouring threads read neighbouring
//   channels of the same corner; a loop over L x P computes each sample's 8
//   corner indices and weights, the sum is kept in float32 and written once.
//
// Bound on an H100 SXM at the flagship (B = 1, H = 8, hd = 24, L = 3 levels
// (16,16,2), (32,32,4), (64,64,8), P = 4, Nq = 37376): memory-bound.  One
// launch must move value 14.4 MB (bf16) + locs 43.1 MB (f32) + weights
// 7.2 MB (bf16) + out 14.4 MB (bf16), about 79 MB, about 24 us at
// 3.35 TB/s; its arithmetic, about 1.5 GFLOP, is negligible beside that.
// The 14 MB value table fits in the 50 MB L2, so the scattered corner reads
// mostly hit L2, but they are 12 samples x 8 rows of 48 bytes per output
// row, 1.38 GB of L2 traffic in all (2.76 GB in float32), which sets the
// row-wide path's pace, as it does K4's (csrc/multilevel_gather3d.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ordered_rows.cuh"

#define MSDG_MAX_LEVELS 8

struct Levels {
  int X[MSDG_MAX_LEVELS];
  int Y[MSDG_MAX_LEVELS];
  int Z[MSDG_MAX_LEVELS];
  int start[MSDG_MAX_LEVELS];
  // K1-bwd's bins (lower corners, ordered_rows.cuh): the level's first bin
  // within a (b, h) and the bins of a (b, h), sum of (X + 1) (Y + 1) (Z + 1)
  int bstart[MSDG_MAX_LEVELS];
  int bins;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid_sample's unnormalization for align_corners=False: the location is
// first mapped to [-1, 1] as the plain version does, then to pixel space.
// The clamp keeps the float-to-int conversion defined; a clamped position
// has every corner outside the level, as the unclamped one has.
__device__ __forceinline__ float unnormalize(float loc01, int size) {
  const float g = loc01 * 2.f - 1.f;
  const float pix = ((g + 1.f) * (float)size - 1.f) * 0.5f;
  return fminf(fmaxf(pix, -2.f), (float)size + 1.f);
}

template <typename T>
__global__ void ms_deform_gather3d_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, T* __restrict__ out, int64_t n_out,
    int Nv, int Nq, int H, int hd, int L, int P, Levels lv) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const int c = (int)(i % hd);
    const int64_t bqh = i / hd;  // ((b * Nq + q) * H + h)
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)H * Nq);
    const float* loc = locs + bqh * L * P * 3;
    const T* w = weights + bqh * L * P;
    // value[b, v, h, c] = vbase[v * vstride]
    const int64_t vstride = (int64_t)H * hd;
    const T* vbase = value + (b * Nv * H + h) * (int64_t)hd + c;

    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int X = lv.X[l], Y = lv.Y[l], Z = lv.Z[l];
      const T* vl = vbase + (int64_t)lv.start[l] * vstride;
      for (int p = 0; p < P; ++p) {
        const int s = l * P + p;
        const float px = unnormalize(loc[s * 3 + 0], X);
        const float py = unnormalize(loc[s * 3 + 1], Y);
        const float pz = unnormalize(loc[s * 3 + 2], Z);
        const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
        const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
        const float wx[2] = {1.f - (px - fx), px - fx};
        const float wy[2] = {1.f - (py - fy), py - fy};
        const float wz[2] = {1.f - (pz - fz), pz - fz};
        float sample = 0.f;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int xi = x0 + dx;
          if (xi < 0 || xi >= X) continue;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int yi = y0 + dy;
            if (yi < 0 || yi >= Y) continue;
            const float wxy = wx[dx] * wy[dy];
            const int64_t row = ((int64_t)xi * Y + yi) * Z;
#pragma unroll
            for (int dz = 0; dz < 2; ++dz) {
              const int zi = z0 + dz;
              if (zi < 0 || zi >= Z) continue;
              sample += wxy * wz[dz] * load_f(vl + (row + zi) * vstride);
            }
          }
        }
        acc += load_f(w + s) * sample;
      }
    }
    store_f(out + i, acc);
  }
}

// ---- the row-wide forward: a lane group per output row ----

// One 16-byte vector of a value row: 8 bf16 or 4 float32 channels.
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
// the channels rounded once to the value's type, as one 16-byte vector
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

// A group of 2^lane_bits lanes per output row r = (b * Nq + q) * H + h; the
// row's L * P samples are dealt out to the lanes, sample s to lane
// s % lanes, so a lane owns whole samples.  The row's nvec 16-byte vectors
// are summed in passes of NV (one pass when the row has at most 6).  Per
// pass, a lane takes its samples SPL at a time: for each it reads the
// location and the attention weight once, picks the level's descriptor by
// an unrolled compare (no dynamic index into the by-value Levels), computes
// the 8 corners with the scalar kernel's unnormalize and folds the attention
// weight into the 8 corner weights; then it issues the 16-byte loads of all
// 8 corners of those samples, VPT vectors of a row at a time, before their
// FMAs, and sums in float32 registers.  A corner outside its level is not
// loaded and has weight 0.  The group then adds its lanes' partial sums
// with a butterfly of shuffles in a fixed order (every lane ends with the
// same bits, and two calls give the same bits), and lane u % lanes stores
// vector u of the pass once.
template <typename T, int NV, int SPL>
__global__ void __launch_bounds__(256) ms_deform_gather3d_rows_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, T* __restrict__ out, int64_t n_rows, int Nv,
    int Nq, int H, int hd, int L, int P, Levels lv, int lane_bits) {
  constexpr int N = Vec16<T>::N;
  constexpr int VPT = SPL == 1 ? 3 : 1;  // vectors of a row per load batch
  const int nvec = hd / N;
  const int LP = L * P;
  const int lanes = 1 << lane_bits;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t & (lanes - 1));
  // the lanes of this thread's group
  const unsigned mask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int64_t groups = ((int64_t)gridDim.x * blockDim.x) >> lane_bits;
  const int64_t vstride = (int64_t)H * nvec;  // vectors from one voxel to the next
  for (int64_t r = t >> lane_bits; r < n_rows; r += groups) {
    const int h = (int)(r % H);
    const int64_t b = r / ((int64_t)H * Nq);
    // value[b, 0, h, 0] and out[b, q, h, 0] as vectors
    const uint4* vb = reinterpret_cast<const uint4*>(value) + (b * Nv * H + h) * nvec;
    uint4* o = reinterpret_cast<uint4*>(out) + r * nvec;
    const float* loc = locs + r * LP * 3;
    const T* aw = weights + r * LP;
    for (int v0 = 0; v0 < nvec; v0 += NV) {
      float acc[NV][N];
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[u][e] = 0.f;
      for (int s0 = lane; s0 < LP; s0 += lanes * SPL) {
        int row[SPL][8];  // corner voxel in value's rows (level start added), or -1
        float cw[SPL][8];
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int s = s0 + k * lanes;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            row[k][q] = -1;
            cw[k][q] = 0.f;
          }
          if (s >= LP) continue;
          const int l = s / P;
          int X = lv.X[0], Y = lv.Y[0], Z = lv.Z[0], start = lv.start[0];
#pragma unroll
          for (int m = 1; m < MSDG_MAX_LEVELS; ++m)
            if (m == l) {
              X = lv.X[m];
              Y = lv.Y[m];
              Z = lv.Z[m];
              start = lv.start[m];
            }
          const float px = unnormalize(loc[s * 3 + 0], X);
          const float py = unnormalize(loc[s * 3 + 1], Y);
          const float pz = unnormalize(loc[s * 3 + 2], Z);
          const float a = load_f(aw + s);
          const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
          const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
          const float wx[2] = {1.f - (px - fx), px - fx};
          const float wy[2] = {1.f - (py - fy), py - fy};
          const float wz[2] = {1.f - (pz - fz), pz - fz};
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dz = 0; dz < 2; ++dz) {
                const int q = dx * 4 + dy * 2 + dz;
                const int xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
                if (xi < 0 || xi >= X || yi < 0 || yi >= Y || zi < 0 || zi >= Z)
                  continue;
                row[k][q] = start + (xi * Y + yi) * Z + zi;
                cw[k][q] = a * (wx[dx] * wy[dy] * wz[dz]);
              }
        }
#pragma unroll
        for (int u0 = 0; u0 < NV; u0 += VPT) {
          uint4 raw[SPL][8][VPT];
#pragma unroll
          for (int k = 0; k < SPL; ++k)
#pragma unroll
            for (int q = 0; q < 8; ++q)
#pragma unroll
              for (int u = 0; u < VPT; ++u) {
                const int v = v0 + u0 + u;
                raw[k][q][u] = (row[k][q] >= 0 && u0 + u < NV && v < nvec)
                                   ? __ldg(vb + row[k][q] * vstride + v)
                                   : make_uint4(0u, 0u, 0u, 0u);
              }
#pragma unroll
          for (int k = 0; k < SPL; ++k)
#pragma unroll
            for (int q = 0; q < 8; ++q)
#pragma unroll
              for (int u = 0; u < VPT; ++u)
                if (u0 + u < NV) fma16(acc[u0 + u], raw[k][q][u], cw[k][q]);
        }
      }
      for (int m = lanes >> 1; m > 0; m >>= 1)
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int e = 0; e < N; ++e) acc[u][e] += __shfl_xor_sync(mask, acc[u][e], m);
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if ((u & (lanes - 1)) == lane && v0 + u < nvec) o[v0 + u] = pack16(acc[u]);
    }
  }
}

// K1-bwd: the VJP of the gather above.  Replaces the TPU kernel
// occformer_tpu/ops/trilerp_fused.py:_wfold_bwd_body (call_bwd :681, its
// pallas_call :684, VJP :713-716).  For every sample (b, q, h, l, p) it
// recomputes the 8 corners exactly as the forward does (same
// unnormalization, same clamp) and, with gout [B, Nq, H, hd]:
//
//   d_value[corner, c] += w * corner_weight * gout[c]
//   d_w                 = sum_c gout[c] * trilerp(value)[c]
//   d_loc[axis]         = w * sum_c gout[c] * d trilerp[c] / d pix[axis] * size
//
// (d pix / d loc = size per axis; a corner outside its level contributes
// nothing, as in F.grid_sample's backward).  Every output is written once in
// its final dtype, with no float atomics, so two calls give the same bits:
// * Sample-major (ms_deform_bwd_samples_kernel): d_w and d_locs.  A thread
//   per sample reads its location and attention weight once, issues the
//   loads of the gout row and of all 8 corner rows, CPP chunks of VEC
//   channels at a time (a 16-byte chunk where hd and the pointers allow:
//   the flagship's bf16 row is 3 of them), before their FMAs, sums the 8
//   dots gout . value[corner] in float32 and stores d_w and the three
//   d_locs slopes itself.  (K4-bwd's d_coords kernel computes the same dots
//   with a null check per corner; written so here it took 0.67 device ms
//   in place of 0.49 at the flagship, PERF.md, section 6.)
// * Destination-major (ordered_rows.cuh): d_value.  Every sample with a
//   corner inside its level is binned once, by its lower corner in its
//   (b, h, level), as an entry (sample, w1x, w1y, w1z); each bin's entries
//   are ordered by sample.  A thread per (d_value row, 16-byte chunk) walks
//   the row's 8 neighbour bins in corner order (the row is corner (dx, dy,
//   dz) of the samples of bin (x - dx, y - dy, z - dz)), each in ascending
//   sample order, adds w * corner_weight * gout[sample's (b, q, h)] in
//   float32 registers and stores the row once in value's dtype (a row no
//   sample touches as zeros).  At the flagship's uniform locations a row
//   takes about 36 (level 64x64x8), 292 (32x32x4) and 2336 (16x16x2)
//   terms.
// The design before this one summed d_value with 16-byte float32 vector
// reductions (red.global.add.v4.f32) into a zeroed float32 buffer and cast
// it: 2.18-2.30 ms bf16 at the flagship's uniform locations, 1.64-1.67 at
// local ones, and sums that changed from run to run (a reloaded train step
// did not repeat its grad_norm).  A per-row segmented gather that recomputed
// each corner weight from its sample's location and ranked spans in
// O(L^2) was 5.73 ms.  An entry per (sample, corner), binned by d_value row
// and sorted by sample (28.7 M entries of 8 bytes), repeated itself but took
// 4.1 ms, the fill's cursor atomics 1.35 and the spans' block sorts 1.15
// (H100 80GB HBM3, 700 W; PERF.md, section 6).
//
// Bound on an H100 SXM at the flagship (B = 1, Nq = 37376, H = 8, hd = 24,
// L = 3, P = 4, bf16), with the count chip_smoke.py uses: each input read
// once and each output written once in its dtype is value 14.4 MB + locs
// 43.1 MB + weights 7.2 MB + gout 14.4 MB in, d_value 14.4 MB + d_locs
// 43.1 MB + d_w 7.2 MB out, about 144 MB, 43 us at 3.35 TB/s.  The function
// needs 8 x 4 float32 operations per (sample, channel) (per corner, one FMA
// of the dot that d_w and d_locs share and the d_value product and add):
// 2.76 GFLOP, 41 us at 67 TFLOP/s.  So bytes bound it, at 43 us.  The fixed
// order adds its binning (3.6 M entries of 16 bytes written, sorted and
// read 8 times, once per corner) and each term's 48-byte gout row and
// attention weight read from L2.
// the level of sample s's descriptor, by an unrolled compare (no dynamic
// index into the by-value Levels)
struct Level1 {
  int X, Y, Z, start;
};
__device__ __forceinline__ Level1 level_at(const Levels& lv, int l) {
  Level1 d{lv.X[0], lv.Y[0], lv.Z[0], lv.start[0]};
#pragma unroll
  for (int m = 1; m < MSDG_MAX_LEVELS; ++m)
    if (m == l) d = Level1{lv.X[m], lv.Y[m], lv.Z[m], lv.start[m]};
  return d;
}

// One sample's lower corner and lerp weights in its level
struct SampleAxes {
  int x0, y0, z0;
  float wx[2], wy[2], wz[2];
};
__device__ __forceinline__ SampleAxes sample_axes(const float* loc, const Level1& d) {
  const float px = unnormalize(loc[0], d.X);
  const float py = unnormalize(loc[1], d.Y);
  const float pz = unnormalize(loc[2], d.Z);
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  SampleAxes a;
  a.x0 = (int)fx;
  a.y0 = (int)fy;
  a.z0 = (int)fz;
  a.wx[1] = px - fx;
  a.wy[1] = py - fy;
  a.wz[1] = pz - fz;
  a.wx[0] = 1.f - a.wx[1];
  a.wy[0] = 1.f - a.wy[1];
  a.wz[0] = 1.f - a.wz[1];
  return a;
}

constexpr int BWD_CPP = 3;  // chunks of a row whose loads a sample issues together

template <typename T, int VEC>
__global__ void __launch_bounds__(256) ms_deform_bwd_samples_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, const T* __restrict__ gout,
    float* __restrict__ d_locs, T* __restrict__ d_weights, int64_t n_samples, int Nv,
    int Nq, int H, int hd, int L, int P, Levels lv) {
  using R = typename Raw<VEC * sizeof(T)>::T;
  const int nchunk = hd / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < n_samples;
       s += stride) {
    // s = ((b * Nq + q) * H + h) * L * P + l * P + p
    const int l = (int)((s / P) % L);
    const int64_t bqh = s / ((int64_t)L * P);
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)H * Nq);
    const Level1 d = level_at(lv, l);
    const SampleAxes ax = sample_axes(locs + s * 3, d);
    const float a = load_f(weights + s);
    int64_t row[8];  // element offset of the corner's value row, or -1
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int xi = ax.x0 + (q >> 2), yi = ax.y0 + ((q >> 1) & 1), zi = ax.z0 + (q & 1);
      const bool ok = xi >= 0 && xi < d.X && yi >= 0 && yi < d.Y && zi >= 0 && zi < d.Z;
      row[q] = ok ? ((b * Nv + d.start + (xi * d.Y + yi) * d.Z + zi) * H + h) * (int64_t)hd
                  : -1;
    }
    const T* g = gout + bqh * hd;
    float gv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) gv[q] = 0.f;
    for (int c0 = 0; c0 < nchunk; c0 += BWD_CPP) {
      R graw[BWD_CPP], vraw[BWD_CPP][8];
#pragma unroll
      for (int u = 0; u < BWD_CPP; ++u) {
        const int c = c0 + u;
        graw[u] = c < nchunk ? *reinterpret_cast<const R*>(g + c * VEC) : R{};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          vraw[u][q] = (c < nchunk && row[q] >= 0)
                           ? __ldg(reinterpret_cast<const R*>(value + row[q] + c * VEC))
                           : R{};
      }
#pragma unroll
      for (int u = 0; u < BWD_CPP; ++u) {
        float gf[VEC];
        chunk_floats<T, VEC>(gf, graw[u]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float vf[VEC];
          chunk_floats<T, VEC>(vf, vraw[u][q]);
#pragma unroll
          for (int k = 0; k < VEC; ++k) gv[q] = fmaf(gf[k], vf[k], gv[q]);
        }
      }
    }
    float dw = 0.f, dgx = 0.f, dgy = 0.f, dgz = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int dx = q >> 2, dy = (q >> 1) & 1, dz = q & 1;
      const float wxd = ax.wx[dx], wyd = ax.wy[dy], wzd = ax.wz[dz];
      dw = fmaf(wxd * wyd * wzd, gv[q], dw);
      dgx = fmaf(dx ? gv[q] : -gv[q], wyd * wzd, dgx);
      dgy = fmaf(dy ? gv[q] : -gv[q], wxd * wzd, dgy);
      dgz = fmaf(dz ? gv[q] : -gv[q], wxd * wyd, dgz);
    }
    store_f(d_weights + s, dw);
    d_locs[s * 3 + 0] = a * dgx * (float)d.X;
    d_locs[s * 3 + 1] = a * dgy * (float)d.Y;
    d_locs[s * 3 + 2] = a * dgz * (float)d.Z;
  }
}

// The lower-corner bin of a sample of (b, h) in level l with lower corner
// (x0, y0, z0), each in [-1, size - 1]
__device__ __forceinline__ int64_t k1_bin(const Levels& lv, const Level1& d, int l, int64_t bh,
                                          int x0, int y0, int z0) {
  int bstart = lv.bstart[0];
#pragma unroll
  for (int m = 1; m < MSDG_MAX_LEVELS; ++m)
    if (m == l) bstart = lv.bstart[m];
  return bh * lv.bins + bstart + ((x0 + 1) * (d.Y + 1) + (y0 + 1)) * (d.Z + 1) + (z0 + 1);
}

// d_value's entries: sample s, with a corner inside its level, binned by its
// lower corner, the entry (s, w1x, w1y, w1z)
struct K1Keys {
  using Entry = BinEntry;
  const float* locs;
  Levels lv;
  int Nq, H, L, P;
  template <class Fn>
  __device__ __forceinline__ void operator()(int64_t s, Fn fn) const {
    const int l = (int)((s / P) % L);
    const int64_t bqh = s / ((int64_t)L * P);
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)H * Nq);
    const Level1 d = level_at(lv, l);
    const SampleAxes ax = sample_axes(locs + s * 3, d);
    if (ax.x0 < -1 || ax.x0 >= d.X || ax.y0 < -1 || ax.y0 >= d.Y || ax.z0 < -1 || ax.z0 >= d.Z)
      return;
    fn(k1_bin(lv, d, l, b * H + h, ax.x0, ax.y0, ax.z0),
       BinEntry{(int)s, {ax.wx[1], ax.wy[1], ax.wz[1]}});
  }
};

// d_value row r = (b * Nv + v) * H + h: its 8 neighbour bins; a term's src
// row (gout's (b, q, h)) and weight w * corner_weight, as the forward forms it
template <typename T>
struct K1Geo {
  static constexpr bool kScaled = true;  // the attention weight
  const T* weights;
  Levels lv;
  int Nv, H, L, P;
  __device__ __forceinline__ void bins(int64_t r, int64_t (&bn)[8]) const {
    const int h = (int)(r % H);
    const int64_t bv = r / H;
    const int v = (int)(bv % Nv);
    const int64_t b = bv / Nv;
    int l = 0;
#pragma unroll
    for (int m = 1; m < MSDG_MAX_LEVELS; ++m)
      if (m < L && v >= lv.start[m]) l = m;
    const Level1 d = level_at(lv, l);
    const int u = v - d.start;
    const int z = u % d.Z, y = u / d.Z % d.Y, x = u / (d.Z * d.Y);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      bn[q] = k1_bin(lv, d, l, b * H + h, x - (q >> 2), y - ((q >> 1) & 1), z - (q & 1));
  }
  __device__ __forceinline__ int64_t src(int s) const { return s / (L * P); }
  __device__ __forceinline__ float scale(int s) const { return load_f(weights + s); }
  __device__ __forceinline__ float weight(float a, float wx, float wy, float wz) const {
    return a * (wx * wy * wz);
  }
};

// A heavy bin's candidates: the Nq * P samples of its (b, h, level)
struct K1Cand {
  Levels lv;
  int Nq, H, L, P;
  __device__ __forceinline__ int64_t count(int64_t) const { return (int64_t)Nq * P; }
  __device__ __forceinline__ int item(int64_t bin, int64_t t) const {
    const int64_t bh = bin / lv.bins;
    const int rem = (int)(bin % lv.bins);
    int l = 0;
#pragma unroll
    for (int m = 1; m < MSDG_MAX_LEVELS; ++m)
      if (m < L && rem >= lv.bstart[m]) l = m;
    const int64_t b = bh / H, h = bh % H;
    return (int)(((b * Nq + t / P) * H + h) * L * P + l * P + t % P);
  }
};

static int read_levels(const int* levels, int L, Levels* lv) {
  if (L < 1 || L > MSDG_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  lv->bins = 0;
  for (int l = 0; l < L; ++l) {
    lv->X[l] = levels[4 * l + 0];
    lv->Y[l] = levels[4 * l + 1];
    lv->Z[l] = levels[4 * l + 2];
    lv->start[l] = levels[4 * l + 3];
    lv->bstart[l] = lv->bins;
    lv->bins += (lv->X[l] + 1) * (lv->Y[l] + 1) * (lv->Z[l] + 1);
  }
  return 0;
}

// Plain C entry points, loaded with ctypes.  Pointers are device pointers;
// `levels` is a HOST array of 4 * L ints: X, Y, Z, start of each level.
// dtype: 0 = float32 value/weights/out, 1 = bfloat16.  Each launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int ms_deform_gather3d_fwd(const void* value, const void* locs,
                                      const void* weights, void* out, int B,
                                      int Nv, int Nq, int H, int hd, int L,
                                      int P, const int* levels, int dtype,
                                      void* stream) {
  Levels lv;
  if (read_levels(levels, L, &lv) != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t n_out = (int64_t)B * Nq * H * hd;
  if (n_out == 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_blocks(n_out, threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    ms_deform_gather3d_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const float*)locs,
        (const __nv_bfloat16*)weights, (__nv_bfloat16*)out, n_out, Nv, Nq, H,
        hd, L, P, lv);
  } else {
    ms_deform_gather3d_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)value, (const float*)locs, (const float*)weights,
        (float*)out, n_out, Nv, Nq, H, hd, L, P, lv);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NV, int SPL>
static void launch_rows(const void* value, const void* locs,
                        const void* weights, void* out, int64_t n_rows, int Nv,
                        int Nq, int H, int hd, int L, int P, const Levels& lv,
                        int lane_bits, cudaStream_t st) {
  const int threads = 256;
  ms_deform_gather3d_rows_kernel<T, NV, SPL>
      <<<grid_blocks(n_rows << lane_bits, threads), threads, 0, st>>>(
          (const T*)value, (const float*)locs, (const T*)weights, (T*)out,
          n_rows, Nv, Nq, H, hd, L, P, lv, lane_bits);
}

template <typename T, int SPL>
static void launch_rows_nv(const void* value, const void* locs,
                           const void* weights, void* out, int64_t n_rows,
                           int Nv, int Nq, int H, int hd, int L, int P,
                           const Levels& lv, int lane_bits, cudaStream_t st) {
  const int nvec = hd / Vec16<T>::N;
#define MSDG_ROWS(NV)                                                     \
  launch_rows<T, NV, SPL>(value, locs, weights, out, n_rows, Nv, Nq, H, hd, \
                          L, P, lv, lane_bits, st)
  switch (nvec) {
    case 1: MSDG_ROWS(1); break;
    case 2: MSDG_ROWS(2); break;
    case 3: MSDG_ROWS(3); break;
    case 4: MSDG_ROWS(4); break;
    case 5: MSDG_ROWS(5); break;
    case 6: MSDG_ROWS(6); break;
    default: MSDG_ROWS(4); break;  // wider rows take passes of 4 vectors
  }
#undef MSDG_ROWS
}

// The row-wide forward: as ms_deform_gather3d_fwd, for value and out
// 16-byte aligned with rows of whole 16-byte vectors (hd a multiple of 8 in
// bfloat16, of 4 in float32); lanes (1, 2, 4, 8, 16 or 32) per output row
// and spl (1, 2 or 3) samples a lane loads at a time.  Returns
// cudaErrorInvalidValue for anything else.
extern "C" int ms_deform_gather3d_fwd_rows(const void* value, const void* locs,
                                           const void* weights, void* out,
                                           int B, int Nv, int Nq, int H,
                                           int hd, int L, int P,
                                           const int* levels, int dtype,
                                           int lanes, int spl, void* stream) {
  Levels lv;
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  if (read_levels(levels, L, &lv) != 0 || (dtype != 0 && dtype != 1) ||
      hd <= 0 || hd % (dtype == 1 ? 8 : 4) != 0 || (1 << lane_bits) != lanes ||
      lanes > 32 || spl < 1 || spl > 3 ||
      ((uintptr_t)value | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_rows = (int64_t)B * Nq * H;
  if (n_rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define MSDG_ROWS_T(T, S)                                                  \
  launch_rows_nv<T, S>(value, locs, weights, out, n_rows, Nv, Nq, H, hd, L, \
                       P, lv, lane_bits, st)
  if (dtype == 1) {
    if (spl == 1) MSDG_ROWS_T(__nv_bfloat16, 1);
    else if (spl == 2) MSDG_ROWS_T(__nv_bfloat16, 2);
    else MSDG_ROWS_T(__nv_bfloat16, 3);
  } else {
    if (spl == 1) MSDG_ROWS_T(float, 1);
    else if (spl == 2) MSDG_ROWS_T(float, 2);
    else MSDG_ROWS_T(float, 3);
  }
#undef MSDG_ROWS_T
  return (int)cudaGetLastError();
}

// K1-bwd's workspace: int32s for ordered_rows.cuh over the B * H bins of
// every level's lower corners and one entry per sample.
extern "C" long long ms_deform_gather3d_bwd_workspace(int B, int Nv, int Nq, int H, int L,
                                                      int P, const int* levels) {
  Levels lv;
  if (read_levels(levels, L, &lv) != 0) return -1;
  return (long long)ordered_rows_ints((int64_t)B * H * lv.bins, (int64_t)B * Nq * H * L * P);
}

// K1-bwd.  value/weights/gout in the forward's dtype; d_value
// [B, Nv, H, hd] in value's dtype, d_locs float32 [B, Nq, H, L, P, 3] and
// d_weights [B, Nq, H, L, P] in weights' dtype, each written in full;
// `workspace` holds ms_deform_gather3d_bwd_workspace(...) int32s, 16-byte
// aligned.  The bins (+ 1) and the samples must lie below 2^31.
extern "C" int ms_deform_gather3d_bwd(const void* value, const void* locs,
                                      const void* weights, const void* gout,
                                      void* d_value, void* d_locs,
                                      void* d_weights, void* workspace, int B, int Nv,
                                      int Nq, int H, int hd, int L, int P,
                                      const int* levels, int dtype,
                                      void* stream) {
  Levels lv;
  const int64_t n_samples = (int64_t)B * Nq * H * L * P;
  const int64_t n_rows = (int64_t)B * Nv * H;
  if (read_levels(levels, L, &lv) != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t n_bins = (int64_t)B * H * lv.bins;
  if (n_bins + 1 >= ((int64_t)1 << 31) || n_samples >= ((int64_t)1 << 31) ||
      (uintptr_t)workspace % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || hd == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int esize = dtype == 1 ? 2 : 4;
  const void* ptrs[3] = {value, gout, d_value};
  const int vec = row_chunk(hd, esize, ptrs, 3);
  const OrderedRowsSpace s = ordered_rows_space(workspace, n_bins, n_samples);
  const int threads = 256;
  const K1Cand cand{lv, Nq, H, L, P};
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (n_samples > 0) {
#define MSDG_BWD_SAMPLES(V)                                                                \
  ms_deform_bwd_samples_kernel<T, V><<<grid_blocks(n_samples, threads), threads, 0, st>>>( \
      (const T*)value, (const float*)locs, (const T*)weights, (const T*)gout,              \
      (float*)d_locs, (T*)d_weights, n_samples, Nv, Nq, H, hd, L, P, lv)
      if (vec == 8) MSDG_BWD_SAMPLES(8);
      else if (vec == 4) MSDG_BWD_SAMPLES(4);
      else if (vec == 2) MSDG_BWD_SAMPLES(2);
      else MSDG_BWD_SAMPLES(1);
    }
    const cudaError_t err = ordered_rows_sum<T>(
        K1Keys{(const float*)locs, lv, Nq, H, L, P}, n_samples,
        K1Geo<T>{(const T*)weights, lv, Nv, H, L, P}, cand, n_bins, n_rows, hd, vec,
        (const T*)gout, (T*)d_value, s, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    using T = float;
    if (n_samples > 0) {
      if (vec == 4) MSDG_BWD_SAMPLES(4);
      else if (vec == 2) MSDG_BWD_SAMPLES(2);
      else MSDG_BWD_SAMPLES(1);
#undef MSDG_BWD_SAMPLES
    }
    const cudaError_t err = ordered_rows_sum<T>(
        K1Keys{(const float*)locs, lv, Nq, H, L, P}, n_samples,
        K1Geo<T>{(const T*)weights, lv, Nv, H, L, P}, cand, n_bins, n_rows, hd, vec,
        (const T*)gout, (T*)d_value, s, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
