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
// lane group gathers directly.  The forward is one row-wide kernel
// (ms_deform_gather3d_rows_kernel) for every row: a group of `lanes` lanes
// (ROW_LANES) takes one output row (b, q, h) and its lanes own whole
// samples of the L x P: a lane reads a sample's location and attention
// weight once, folds the weight into the 8 corner weights, issues the loads
// of all 8 corner rows as vectors (VPT of a row at a time: 48 bytes, at
// most 12 vectors) before their FMAs and sums in float32 registers; the
// group adds its lanes' sums with a fixed shuffle butterfly (two calls give
// the same bits) and stores the row once, as vectors.  The vector width is
// the widest of 16, 8, 4 and 2 bytes that divides the row's bytes and the
// value's and output's addresses (ops/trilerp_fused.py:ms_deform_fwd_path):
// the flagship's hd = 24 rows take 16 bytes in bf16 and float32, hd = 12 in
// bf16 (24-byte rows) 8, hd = 7 in bf16 2.  A row of nvec vectors is summed
// in one pass of NV >= nvec vectors (16-byte vectors: NV = nvec up to 6;
// narrower: the next of 1, 2, 3, 4, 6, 8, 16, 32, 64, at most 64 channels
// a pass) and a longer row in passes of 4 (16 bytes) or 64 channels; a
// vector past the row's end is not loaded (it adds zeros to a sum that is
// not stored).
// A misaligned value is copied once to an aligned buffer by the launcher
// (ops/trilerp_fused.py:_launch_fwd), not read with the narrower vector its
// address allows: at the flagship's shapes in float32 with the value 4 bytes
// past a 16-byte boundary, 4-byte vectors took 1.155 device ms and the copy
// with 16-byte vectors 0.700 (time_backwards.py K1.other, H100 80GB HBM3,
// 700 W); the copy moves 28.7 MB and holds a second value for the call.
// Lanes per row x samples a lane loads at a time (a template option until
// it was fixed at one sample, the sweep's choice everywhere: at hd 12 in
// bf16, 6 in float32 and 7 in bf16 2 or 3 samples at a time took 1.5-2.7x
// longer, and 2 lanes a row was the best of 1-8 there too:
// time_backwards.py --only K1.other --sweep), from
// occformer_tpu_torch/tools/time_backwards.py --sweep at the flagship's
// shapes on an H100 80GB HBM3 at 700 W, ms bf16 uniform / local, float32
// uniform / local locations: 1x1 0.410 / 0.234-0.248 / 0.794-0.822 /
// 0.406-0.411, 2x1 0.390-0.391 / 0.217-0.233 / 0.708-0.712 /
// 0.353-0.355, 4x1 0.397-0.398 / 0.234-0.239 / 0.709-0.710 / 0.413,
// 8x1 0.413-0.415 / 0.322-0.323 / 0.735-0.739 / 0.551-0.561, 16x1
// 0.414-0.415 / 0.370 / 0.741-0.746 / 0.635-0.653, 32x1 0.694 / 0.665-0.693
// / 1.092 / 0.989-0.994; 2 samples at a time (1 vector a batch) tie at 1
// lane on local locations and are 0.02-0.99 ms slower everywhere else, 3
// slower again.  ROW_LANES = 2, one sample at a time.
// The first design ran one thread per output channel: the 24 threads of a
// (b, q, h) each re-read its 36 location floats and 12 weights, redid the
// 12 samples' unnormalize, floor and corner weights, and loaded 2 bytes a
// corner, a warp straddling two heads' rows: 1.25 ms bf16 at the flagship
// (1.24 / 1.07 / 1.47 / 1.10 in the sweep's terms), 1.9% of its bound.  It
// took every row but the whole 16-byte vectors (hd = 12 in bf16, a
// misaligned value), at 2% of their bounds (PERF.md, section 6).
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

// ---- the row-wide forward: a lane group per output row ----

// A group of 2^lane_bits lanes per output row r = (b * Nq + q) * H + h; the
// row's L * P samples are dealt out to the lanes, sample s to lane
// s % lanes, so a lane owns whole samples.  The row is read and written as
// nvec vectors of VB bytes (N = VB / sizeof(T) channels each), summed in
// passes of NV vectors.  Per pass, a lane takes its samples one at a time:
// for each it reads the location and the attention weight once, picks the
// level's descriptor by an unrolled compare (no dynamic index into the
// by-value Levels), computes the 8 corners with grid_sample's unnormalize
// and folds the attention weight into the 8 corner weights; then it issues
// the loads of all 8 corners, VPT vectors of a row at a time, before their
// FMAs, and sums in float32 registers.  A corner outside its level, and a
// vector past the row's end, is not loaded (it adds zeros to a sum that is
// not stored).  The group then adds its lanes' partial sums with a
// butterfly of shuffles in a fixed order (every lane ends with the same
// bits, and two calls give the same bits), and lane u % lanes stores
// vector u of the pass once.
template <typename T, int VB, int NV>
__global__ void __launch_bounds__(256) ms_deform_gather3d_rows_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, T* __restrict__ out, int64_t n_rows, int Nv,
    int Nq, int H, int hd, int L, int P, Levels lv, int lane_bits) {
  using R = typename Raw<VB>::T;
  constexpr int N = VB / sizeof(T);
  // vectors of a row per load batch: 48 bytes of each corner row, at most 12
  constexpr int VPT = 48 / VB < 12 ? 48 / VB : 12;
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
    const R* vb = reinterpret_cast<const R*>(value) + (b * Nv * H + h) * nvec;
    R* o = reinterpret_cast<R*>(out) + r * nvec;
    const float* loc = locs + r * LP * 3;
    const T* aw = weights + r * LP;
    for (int v0 = 0; v0 < nvec; v0 += NV) {
      float acc[NV][N];
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[u][e] = 0.f;
      for (int s = lane; s < LP; s += lanes) {
        int row[8];  // corner voxel in value's rows (level start added), or -1
        float cw[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          row[q] = -1;
          cw[q] = 0.f;
        }
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
              if (xi < 0 || xi >= X || yi < 0 || yi >= Y || zi < 0 || zi >= Z) continue;
              row[q] = start + (xi * Y + yi) * Z + zi;
              cw[q] = a * (wx[dx] * wy[dy] * wz[dz]);
            }
#pragma unroll
        for (int u0 = 0; u0 < NV; u0 += VPT) {
          R raw[8][VPT];
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int u = 0; u < VPT; ++u) {
              const int v = v0 + u0 + u;
              raw[q][u] = (row[q] >= 0 && u0 + u < NV && v < nvec)
                              ? __ldg(vb + row[q] * vstride + v)
                              : R{};
            }
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int u = 0; u < VPT; ++u)
              if (u0 + u < NV) fma_vec<T, VB>(acc[u0 + u], raw[q][u], cw[q]);
        }
      }
      for (int m = lanes >> 1; m > 0; m >>= 1)
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int e = 0; e < N; ++e) acc[u][e] += __shfl_xor_sync(mask, acc[u][e], m);
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if ((u & (lanes - 1)) == lane && v0 + u < nvec) o[v0 + u] = pack_vec<T, VB>(acc[u]);
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

template <typename T, int VB, int NV>
static void launch_rows(const void* value, const void* locs,
                        const void* weights, void* out, int64_t n_rows, int Nv,
                        int Nq, int H, int hd, int L, int P, const Levels& lv,
                        int lane_bits, cudaStream_t st) {
  const int threads = 256;
  ms_deform_gather3d_rows_kernel<T, VB, NV>
      <<<grid_blocks(n_rows << lane_bits, threads), threads, 0, st>>>(
          (const T*)value, (const float*)locs, (const T*)weights, (T*)out,
          n_rows, Nv, Nq, H, hd, L, P, lv, lane_bits);
}

// The pass width NV for a row of nvec vectors of VB bytes: 16-byte vectors
// nvec itself up to 6, else passes of 4; narrower ones the next of 1, 2, 3,
// 4, 6, 8, 16, 32, 64 vectors, at most 64 channels a pass (a longer row
// takes passes of 64 channels).
template <typename T, int VB>
static void launch_rows_nv(const void* value, const void* locs,
                           const void* weights, void* out, int64_t n_rows,
                           int Nv, int Nq, int H, int hd, int L, int P,
                           const Levels& lv, int lane_bits, cudaStream_t st) {
  const int nvec = hd / (VB / (int)sizeof(T));
#define MSDG_ROWS(NV)                                                         \
  launch_rows<T, VB, NV>(value, locs, weights, out, n_rows, Nv, Nq, H, hd, \
                              L, P, lv, lane_bits, st)
  if constexpr (VB == 16) {
    switch (nvec) {
      case 1: MSDG_ROWS(1); break;
      case 2: MSDG_ROWS(2); break;
      case 3: MSDG_ROWS(3); break;
      case 4: MSDG_ROWS(4); break;
      case 5: MSDG_ROWS(5); break;
      case 6: MSDG_ROWS(6); break;
      default: MSDG_ROWS(4); break;  // wider rows take passes of 4 vectors
    }
  } else {
    constexpr int CAP = 64 / (VB / (int)sizeof(T));  // vectors of 64 channels
    if (nvec <= 1) MSDG_ROWS(1);
    else if (nvec <= 2) MSDG_ROWS(2);
    else if (nvec <= 3) MSDG_ROWS(3);
    else if (nvec <= 4) MSDG_ROWS(4);
    else if (nvec <= 6) MSDG_ROWS(6);
    else if (nvec <= 8) MSDG_ROWS(8);
    else if (CAP == 16 || nvec <= 16) MSDG_ROWS(16);
    else if constexpr (CAP >= 32) {
      if (CAP == 32 || nvec <= 32) MSDG_ROWS(32);
      else if constexpr (CAP >= 64) MSDG_ROWS(64);
    }
  }
#undef MSDG_ROWS
}

// Plain C entry points, loaded with ctypes.  Pointers are device pointers;
// `levels` is a HOST array of 4 * L ints: X, Y, Z, start of each level.
// dtype: 0 = float32 value/weights/out, 1 = bfloat16.  Each launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
//
// K1: value [B, Nv, H, hd], locs float32 [B, Nq, H, L, P, 3], weights
// [B, Nq, H, L, P], out [B, Nq, H, hd], read and written as vectors of
// `vec` bytes (16, 8, 4 or 2; at least one element) that divide hd's bytes
// and value's and out's addresses, with lanes (1, 2, 4, 8, 16 or 32) per
// output row.  Returns cudaErrorInvalidValue for anything else.
extern "C" int ms_deform_gather3d_fwd_rows(const void* value, const void* locs,
                                           const void* weights, void* out,
                                           int B, int Nv, int Nq, int H,
                                           int hd, int L, int P,
                                           const int* levels, int dtype, int vec,
                                           int lanes, void* stream) {
  Levels lv;
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  const int esize = dtype == 1 ? 2 : 4;
  if (read_levels(levels, L, &lv) != 0 || (dtype != 0 && dtype != 1) || hd <= 0 ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 2) || vec < esize ||
      (hd * esize) % vec != 0 || (1 << lane_bits) != lanes || lanes > 32 ||
      ((uintptr_t)value | (uintptr_t)out) % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_rows = (int64_t)B * Nq * H;
  if (n_rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define MSDG_ROWS_T(T, VB)                                                   \
  launch_rows_nv<T, VB>(value, locs, weights, out, n_rows, Nv, Nq, H, hd, L, P, \
                        lv, lane_bits, st)
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (vec == 16) MSDG_ROWS_T(T, 16);
    else if (vec == 8) MSDG_ROWS_T(T, 8);
    else if (vec == 4) MSDG_ROWS_T(T, 4);
    else MSDG_ROWS_T(T, 2);
  } else {
    using T = float;
    if (vec == 16) MSDG_ROWS_T(T, 16);
    else if (vec == 8) MSDG_ROWS_T(T, 8);
    else MSDG_ROWS_T(T, 4);
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
