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
// directly.  Forward: one thread per output (g, s, c), c fastest, so that a
// warp reads neighbouring channels of the same corner.  Backward: the same
// mapping, with float32 atomics into a zeroed [G, X*Y*Z, C] d_table (what the
// Pallas VJP returns before its cast to the table's dtype); when the caller
// asks for d_coords, each thread also adds its channel's share of the three
// coordinate derivatives with atomics into a zeroed [G, S, 3] buffer.
//
// Bounds on an H100 SXM at the flagship's candidate readout (table
// [1, 128, 128, 16, 192] bf16, 100.7 MB; S = 150528): both are memory-bound.
// Forward: table 100.7 MB + coords 1.8 MB read, out 57.8 MB written, about
// 160 MB, about 48 us at 3.35 TB/s.  Backward: gout 57.8 MB + coords 1.8 MB
// read, d_table 100.7 MB written in the table's dtype, about 160 MB, about
// 48 us (the table itself is read only when d_coords is asked for).  This
// simple form writes a float32 d_table (201.3 MB) and casts it afterwards,
// as the Pallas VJP does.  The scattered corner reads of the forward mostly
// miss L2 (the table is twice its size); the backward's atomics hit a
// 201 MB buffer, far beyond L2.

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

// d_table float32 [G, X, Y, Z, C] ZEROED by the caller; d_coords float32
// [G, S, 3] ZEROED by the caller, or NULL when no coordinate gradient is
// wanted (the table is then never read).  dtype 0 or 1 as above.
extern "C" int trilerp_sample3d_bwd(const void* table, const void* coords,
                                    const void* gout, void* d_table,
                                    void* d_coords, int G, int S, int X, int Y,
                                    int Z, int C, int align, int border,
                                    int dtype, void* stream) {
  const int64_t n_out = (int64_t)G * S * C;
  if (n_out == 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_blocks(n_out, threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    trilerp_bwd_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)table, (const float*)coords, (const float*)gout,
        (float*)d_table, (float*)d_coords, n_out, S, X, Y, Z, C, align, border);
  } else if (dtype == 1) {
    trilerp_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)table, (const float*)coords,
        (const __nv_bfloat16*)gout, (float*)d_table, (float*)d_coords, n_out,
        S, X, Y, Z, C, align, border);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
