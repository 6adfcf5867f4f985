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

#define MSDG_MAX_LEVELS 8

struct Levels {
  int X[MSDG_MAX_LEVELS];
  int Y[MSDG_MAX_LEVELS];
  int Z[MSDG_MAX_LEVELS];
  int start[MSDG_MAX_LEVELS];
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
// occformer_tpu/ops/trilerp_fused.py:_wfold_bwd_body (call_bwd, VJP :713-716).
// For every sample (b, q, h, l, p) it recomputes the 8 corners exactly as the
// forward does (same unnormalization, same clamp) and, with gout [B, Nq, H, hd]:
//
//   d_value[corner, c] += w * corner_weight * gout[c]        (float32 reductions)
//   d_w                 = sum_c gout[c] * trilerp(value)[c]
//   d_loc[axis]         = w * sum_c gout[c] * d trilerp[c] / d pix[axis] * size
//
// (d pix / d loc = size per axis; a corner outside its level contributes
// nothing, as in F.grid_sample's backward).  d_value is the float32 buffer the
// Pallas VJP also returns; the wrapper casts it to value's dtype once.
//
// Design: d_value (28.7 MB float32 at the flagship) fits in the 50 MB L2, so
// the kernel keeps reductions into it and makes them fewer and wider.  A
// group of 4 lanes takes one sample (eight samples per warp); its lanes walk
// the sample's (corner, 4-channel quad) units, corner-major so that
// neighbouring lanes touch neighbouring quads of one corner row: 48 units at
// hd = 24, twelve per lane, no lane idle.  Each unit loads its value quad and
// gout quad with one 16-byte (float32) or 8-byte (bf16) load and adds its
// four d_value terms with one red.global.add.v4.f32 (sm_90): 8 * hd / 4
// vector reductions per sample (172 M at the flagship) where the first
// version issued 8 * hd scalar atomics (689 M).  A lane issues the loads of
// 3 units before their arithmetic and reductions, so that loads overlap.
// d_weights and the three d_locs slopes need only the quad's dot
// sum_c gout * value per corner; they are summed within the group by
// shuffles and stored by its first lane, with no atomics.  When hd is not a
// multiple of 4 (or a pointer is not aligned for the vector access) the
// same mapping runs with one channel per unit and scalar atomics.
//
// What limits it is the latency of each sample's dependent loads (its
// locations, then its corner rows), not the reductions: the same kernel
// with the reductions removed took 2.23 ms at the flagship's uniform bf16
// locations where the whole took 3.5 (H100 80GB HBM3, 700 W; 16-lane
// groups, one unit's loads at a time).  So the group size and the loads in
// flight (BWD_GROUP, BWD_INFLIGHT) were set for the most samples and loads
// in flight per warp that registers allow, from occformer_tpu_torch/tools/
// time_backwards.py on that card, uniform / local locations, ms: 16 lanes
// x 1 unit 3.51-3.58 / 2.88-3.00; 8 x 3 2.47-2.53 / 2.06-2.24; 4 x 2
// 2.24-2.26 / 1.64-1.67; 4 x 3 2.19-2.20 / 1.66-1.67; 4 x 4 2.51-2.63 /
// 1.94-2.02; 4 x 12 4.16-4.25 / 3.33-3.36; 2 x 6 2.16-2.22 / 1.72.
// A block-local shared-memory window over the small levels' d_value rows
// (fewer L2 reductions) and a per-row segmented gather of d_value (no float
// reductions) were slower or no faster (PERF.md).
//
// Bound on an H100 SXM at the flagship (B = 1, Nq = 37376, H = 8, hd = 24,
// L = 3, P = 4, bf16), with the count chip_smoke.py uses: each input read
// once and each output written once in its dtype is value 14.4 MB + locs
// 43.1 MB + weights 7.2 MB + gout 14.4 MB in, d_value 14.4 MB + d_locs
// 43.1 MB + d_w 7.2 MB out, about 144 MB, 43 us at 3.35 TB/s.  The function
// needs 8 x 4 float32 operations per (sample, channel) (per corner, one FMA
// of the dot that d_w and d_locs share and the d_value product and add):
// 2.76 GFLOP, 41 us at 67 TFLOP/s.  So bytes bound it, at 43 us.
constexpr int BWD_GROUP = 4;     // lanes per sample
constexpr int BWD_INFLIGHT = 3;  // units per lane whose loads are issued together

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    *reinterpret_cast<unsigned*>(&a) = u.x;
    *reinterpret_cast<unsigned*>(&b) = u.y;
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <typename T, int VEC>
__global__ void ms_deform_gather3d_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, const T* __restrict__ gout,
    float* __restrict__ d_value, float* __restrict__ d_locs,
    float* __restrict__ d_weights, int64_t n_samples, int Nv, int Nq, int H,
    int hd, int L, int P, Levels lv) {
  const int sub = threadIdx.x & (BWD_GROUP - 1);
  // the lanes of this thread's group
  const unsigned mask = ((1u << BWD_GROUP) - 1u) << (threadIdx.x & (32 - BWD_GROUP));
  const int nq = hd / VEC;
  const int units = 8 * nq;
  const int per_block = blockDim.x / BWD_GROUP;
  const int64_t groups = (int64_t)gridDim.x * per_block;
  for (int64_t s = (int64_t)blockIdx.x * per_block + threadIdx.x / BWD_GROUP;
       s < n_samples; s += groups) {
    // s = ((b * Nq + q) * H + h) * L * P + l * P + p; uniform in the group
    const int l = (int)((s / P) % L);
    const int64_t bqh = s / ((int64_t)L * P);
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)H * Nq);
    const int X = lv.X[l], Y = lv.Y[l], Z = lv.Z[l];
    const float px = unnormalize(locs[s * 3 + 0], X);
    const float py = unnormalize(locs[s * 3 + 1], Y);
    const float pz = unnormalize(locs[s * 3 + 2], Z);
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
    const float wx1 = px - fx, wy1 = py - fy, wz1 = pz - fz;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1, wz0 = 1.f - wz1;
    const float w = load_f(weights + s);
    const int64_t vstride = (int64_t)H * hd;
    // element offset of value[b, start_l, h, 0]
    const int64_t vbase = (b * Nv * H + h) * (int64_t)hd + (int64_t)lv.start[l] * vstride;
    const T* g_row = gout + bqh * hd;

    float dw = 0.f, dgx = 0.f, dgy = 0.f, dgz = 0.f;
    for (int u0 = sub; u0 < units; u0 += BWD_GROUP * BWD_INFLIGHT) {
      // the loads of up to BWD_INFLIGHT units first, then their arithmetic
      // and reductions, so that the loads overlap
      float v[BWD_INFLIGHT][VEC], g[BWD_INFLIGHT][VEC];
      int64_t off[BWD_INFLIGHT];
      int corner[BWD_INFLIGHT];  // -1: no unit, or a corner outside the level
#pragma unroll
      for (int k = 0; k < BWD_INFLIGHT; ++k) {
        const int u = u0 + k * BWD_GROUP;
        corner[k] = -1;
        if (u >= units) continue;
        const int c = u / nq;
        const int q = u - c * nq;
        const int xi = x0 + (c >> 2), yi = y0 + ((c >> 1) & 1), zi = z0 + (c & 1);
        if (xi < 0 || xi >= X || yi < 0 || yi >= Y || zi < 0 || zi >= Z) continue;
        corner[k] = c;
        off[k] = vbase + (((int64_t)xi * Y + yi) * Z + zi) * vstride + q * VEC;
        load_vec<VEC>(value + off[k], v[k]);
        load_vec<VEC>(g_row + q * VEC, g[k]);
      }
#pragma unroll
      for (int k = 0; k < BWD_INFLIGHT; ++k) {
        if (corner[k] < 0) continue;
        const int dx = corner[k] >> 2, dy = (corner[k] >> 1) & 1, dz = corner[k] & 1;
        const float wxd = dx ? wx1 : wx0, wyd = dy ? wy1 : wy0, wzd = dz ? wz1 : wz0;
        const float cw = wxd * wyd * wzd;
        const float wcw = w * cw;
        float gv = 0.f, upd[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          gv = fmaf(g[k][j], v[k][j], gv);
          upd[j] = wcw * g[k][j];
        }
        red_add<VEC>(d_value + off[k], upd);
        dw = fmaf(cw, gv, dw);
        dgx = fmaf(dx ? gv : -gv, wyd * wzd, dgx);
        dgy = fmaf(dy ? gv : -gv, wxd * wzd, dgy);
        dgz = fmaf(dz ? gv : -gv, wxd * wyd, dgz);
      }
    }
#pragma unroll
    for (int m = BWD_GROUP / 2; m > 0; m >>= 1) {
      dw += __shfl_xor_sync(mask, dw, m);
      dgx += __shfl_xor_sync(mask, dgx, m);
      dgy += __shfl_xor_sync(mask, dgy, m);
      dgz += __shfl_xor_sync(mask, dgz, m);
    }
    if (sub == 0) {
      d_weights[s] = dw;
      d_locs[s * 3 + 0] = w * dgx * (float)X;
      d_locs[s * 3 + 1] = w * dgy * (float)Y;
      d_locs[s * 3 + 2] = w * dgz * (float)Z;
    }
  }
}

static int read_levels(const int* levels, int L, Levels* lv) {
  if (L < 1 || L > MSDG_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    lv->X[l] = levels[4 * l + 0];
    lv->Y[l] = levels[4 * l + 1];
    lv->Z[l] = levels[4 * l + 2];
    lv->start[l] = levels[4 * l + 3];
  }
  return 0;
}

static unsigned grid_blocks(int64_t work_items, int per_block) {
  int64_t blocks = (work_items + per_block - 1) / per_block;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return (unsigned)blocks;
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

// K1-bwd.  value/weights/gout in the forward's dtype; d_value float32
// [B, Nv, H, hd], ZEROED by the caller (the kernel adds into it); d_locs
// float32 [B, Nq, H, L, P, 3] and d_weights float32 [B, Nq, H, L, P] are
// written in full.
extern "C" int ms_deform_gather3d_bwd(const void* value, const void* locs,
                                      const void* weights, const void* gout,
                                      void* d_value, void* d_locs,
                                      void* d_weights, int B, int Nv, int Nq,
                                      int H, int hd, int L, int P,
                                      const int* levels, int dtype,
                                      void* stream) {
  Levels lv;
  if (read_levels(levels, L, &lv) != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t n_samples = (int64_t)B * Nq * H * L * P;
  if (n_samples == 0) return 0;
  const int threads = 256;  // groups of BWD_GROUP lanes, one sample each
  const unsigned blocks = grid_blocks(n_samples, threads / BWD_GROUP);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t esize = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  // 4-channel units need hd % 4 == 0 and quads aligned for their loads
  // (4 * esize bytes) and for the float32 reductions (16 bytes)
  const bool quads = hd % 4 == 0 && (uintptr_t)value % (4 * esize) == 0 &&
                     (uintptr_t)gout % (4 * esize) == 0 &&
                     (uintptr_t)d_value % 16 == 0;
#define MSDG_BWD(T, VEC)                                                      \
  ms_deform_gather3d_bwd_kernel<T, VEC><<<blocks, threads, 0, st>>>(         \
      (const T*)value, (const float*)locs, (const T*)weights, (const T*)gout, \
      (float*)d_value, (float*)d_locs, (float*)d_weights, n_samples, Nv, Nq,  \
      H, hd, L, P, lv)
  if (dtype == 1) {
    if (quads) MSDG_BWD(__nv_bfloat16, 4);
    else MSDG_BWD(__nv_bfloat16, 1);
  } else {
    if (quads) MSDG_BWD(float, 4);
    else MSDG_BWD(float, 1);
  }
#undef MSDG_BWD
  return (int)cudaGetLastError();
}
