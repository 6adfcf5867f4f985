// Multi-scale deformable-attention gather over 3D voxel pyramids (K1).
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

// Plain C entry point, loaded with ctypes.  Pointers are device pointers;
// `levels` is a HOST array of 4 * L ints: X, Y, Z, start of each level.
// dtype: 0 = float32 value/weights/out, 1 = bfloat16.  Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int ms_deform_gather3d_fwd(const void* value, const void* locs,
                                      const void* weights, void* out, int B,
                                      int Nv, int Nq, int H, int hd, int L,
                                      int P, const int* levels, int dtype,
                                      void* stream) {
  if (L < 1 || L > MSDG_MAX_LEVELS || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.X[l] = levels[4 * l + 0];
    lv.Y[l] = levels[4 * l + 1];
    lv.Z[l] = levels[4 * l + 2];
    lv.start[l] = levels[4 * l + 3];
  }
  const int64_t n_out = (int64_t)B * Nq * H * hd;
  if (n_out == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    ms_deform_gather3d_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)value, (const float*)locs,
        (const __nv_bfloat16*)weights, (__nv_bfloat16*)out, n_out, Nv, Nq, H,
        hd, L, P, lv);
  } else {
    ms_deform_gather3d_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)value, (const float*)locs, (const float*)weights,
        (float*)out, n_out, Nv, Nq, H, hd, L, P, lv);
  }
  return (int)cudaGetLastError();
}
