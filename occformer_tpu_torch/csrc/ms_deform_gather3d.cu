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
// Design: the 3D analogue of Deformable-DETR's ms_deform_attn im2col kernel.
// The one-hot matmuls, 16-row windows, escape pass and padded meta rows of
// the Pallas kernel exist only because the TPU gathers badly; here every
// thread gathers directly.  One thread per output element (b, q, h, c), with
// c fastest so that neighbouring threads read neighbouring channels of the
// same corner; a loop over L x P computes each sample's 8 corner indices and
// weights once, the sum is kept in float32 and written once.
//
// Bound on an H100 SXM at the flagship (B = 1, H = 8, hd = 24, L = 3 levels
// (16,16,2), (32,32,4), (64,64,8), P = 4, Nq = 37376): memory-bound.  One
// launch must move value 14.4 MB (bf16) + locs 43.1 MB (f32) + weights
// 7.2 MB (bf16) + out 14.4 MB (bf16), about 79 MB, about 24 us at
// 3.35 TB/s; its arithmetic, about 1.5 GFLOP, is negligible beside that.
// The 14 MB value table fits in the 50 MB L2, so the scattered corner reads
// mostly hit L2; locs dominate the traffic and are read once, coalesced.
// Faster variants (shared-memory staging of locs, 16-byte vector loads of
// the channel row) are later work.

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

// K1-bwd: the VJP of the gather above.  Replaces the TPU kernel
// occformer_tpu/ops/trilerp_fused.py:_wfold_bwd_body (call_bwd, VJP :713-716).
// For every sample (b, q, h, l, p) it recomputes the 8 corners exactly as the
// forward does (same unnormalization, same clamp) and, with gout [B, Nq, H, hd]:
//
//   d_value[corner, c] += w * corner_weight * gout[c]        (float32 atomics)
//   d_w                 = sum_c gout[c] * trilerp(value)[c]
//   d_loc[axis]         = w * sum_c gout[c] * d trilerp[c] / d pix[axis] * size
//
// (d pix / d loc = size per axis; a corner outside its level contributes
// nothing, as in F.grid_sample's backward).  d_value is the float32 buffer the
// Pallas VJP also returns; the wrapper casts it to value's dtype.
//
// Design: one warp per sample, its lanes over the channels (chunks of 32).
// The warp's corner reads and its d_value atomics then touch hd neighbouring
// addresses (coalesced, one L2 sector run per corner), and d_w / d_loc are a
// warp-shuffle sum with no atomics.  With hd = 24, 8 of 32 lanes idle.
//
// Bound on an H100 SXM at the flagship (B = 1, Nq = 37376, H = 8, hd = 24,
// L = 3, P = 4, bf16): each input read once and each output written once in
// its dtype is value 14.4 MB + locs 43.1 MB + weights 7.2 MB + gout 14.4 MB
// in, d_value 14.4 MB + d_locs 43.1 MB + d_w 7.2 MB out, about 144 MB, 43 us
// at 3.35 TB/s; the float32 arithmetic (8 corners x 9 operations per sample
// and channel, 6.2 GFLOP) takes 93 us at 67 TFLOP/s, so operations bound it.
// The kernel issues 8 * hd float32 atomics per sample (690 M at the
// flagship) into a 28.7 MB buffer that stays in L2; their rate, not DRAM or
// the arithmetic, is what limits this simple form.
template <typename T>
__global__ void ms_deform_gather3d_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ weights, const T* __restrict__ gout,
    float* __restrict__ d_value, float* __restrict__ d_locs,
    float* __restrict__ d_weights, int64_t n_samples, int Nv, int Nq, int H,
    int hd, int L, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t s = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       s < n_samples; s += warps) {
    // s = ((b * Nq + q) * H + h) * L * P + l * P + p; uniform in the warp
    const int p = (int)(s % P);
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
    const float wx[2] = {1.f - (px - fx), px - fx};
    const float wy[2] = {1.f - (py - fy), py - fy};
    const float wz[2] = {1.f - (pz - fz), pz - fz};
    const float w = load_f(weights + s);
    const int64_t vstride = (int64_t)H * hd;
    // element offset of value[b, start_l, h, 0]
    const int64_t vbase = (b * Nv * H + h) * (int64_t)hd + (int64_t)lv.start[l] * vstride;
    const T* g_row = gout + bqh * hd;

    float dw = 0.f, dgx = 0.f, dgy = 0.f, dgz = 0.f;
    for (int c0 = 0; c0 < hd; c0 += 32) {
      const int c = c0 + lane;
      if (c >= hd) continue;
      const float g = load_f(g_row + c);
      const float gw = g * w;
      float sv = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = x0 + dx;
        if (xi < 0 || xi >= X) continue;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int yi = y0 + dy;
          if (yi < 0 || yi >= Y) continue;
          const int64_t row = ((int64_t)xi * Y + yi) * Z;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            const int zi = z0 + dz;
            if (zi < 0 || zi >= Z) continue;
            const int64_t off = vbase + (row + zi) * vstride + c;
            const float v = load_f(value + off);
            const float cw = wx[dx] * wy[dy] * wz[dz];
            sv += cw * v;
            sx += (dx ? v : -v) * wy[dy] * wz[dz];
            sy += (dy ? v : -v) * wx[dx] * wz[dz];
            sz += (dz ? v : -v) * wx[dx] * wy[dy];
            atomicAdd(d_value + off, gw * cw);
          }
        }
      }
      dw += g * sv;
      dgx += g * sx;
      dgy += g * sy;
      dgz += g * sz;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      dw += __shfl_xor_sync(0xffffffffu, dw, m);
      dgx += __shfl_xor_sync(0xffffffffu, dgx, m);
      dgy += __shfl_xor_sync(0xffffffffu, dgy, m);
      dgz += __shfl_xor_sync(0xffffffffu, dgz, m);
    }
    if (lane == 0) {
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
  const int threads = 256;  // 8 warps, one sample each
  const unsigned blocks = grid_blocks(n_samples, threads / 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    ms_deform_gather3d_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const float*)locs,
        (const __nv_bfloat16*)weights, (const __nv_bfloat16*)gout,
        (float*)d_value, (float*)d_locs, (float*)d_weights, n_samples, Nv, Nq,
        H, hd, L, P, lv);
  } else {
    ms_deform_gather3d_bwd_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)value, (const float*)locs, (const float*)weights,
        (const float*)gout, (float*)d_value, (float*)d_locs,
        (float*)d_weights, n_samples, Nv, Nq, H, hd, L, P, lv);
  }
  return (int)cudaGetLastError();
}
