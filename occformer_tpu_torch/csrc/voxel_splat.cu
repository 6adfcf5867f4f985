// The LSS voxel splat (S1): the lifted depth x context features summed by
// voxel, in a fixed order.
//
// Port of occformer_tpu/ops/scatter.py:voxel_scatter_lifted (:55), which
// the JAX package leaves to XLA's scatter-add (no Pallas kernel; its sums
// repeat themselves run to run):
//
//   out[r, c] = sum over the frustum points p with rows[p] == r of
//               depth[p] * ctx[pixel(p), c]
//
// with depth [B, N, D, fH, fW] (p = ((b * N + n) * D + d) * fH * fW + h * fW
// + w), ctx [B, N, fH, fW, C] (pixel(p) = (b * N + n) * fH * fW + h * fW +
// w) and rows the voxel of each point (invalid points in a dummy row that no
// thread reads).  The sum is kept in float32.
//
// Why a kernel: index_add_ adds with float atomics in an order that changes
// from run to run, so two identical train steps differed in the last bits
// of their losses; PyTorch's deterministic index_add_ (a sort, then one
// serial sum per voxel) and a sort plus torch.segment_reduce took 300 and
// 46 device ms a frame at the flagship's shapes.  Here the wrapper sorts the
// points by voxel once (a stable integer sort, so ascending point order
// within a voxel) and builds the segment offsets; then one thread per
// (voxel, channel) walks its voxel's points in that order, reading the
// point's depth (the same for the 32 lanes of a warp: one broadcast) and
// 32 neighbouring channels of its pixel's context row per warp, and writes
// its sum once.  The lift product is never stored.  No atomics: the same
// bits on every run.  The backward is gathers (ops/scatter.py).
//
// Bound on an H100 SXM at the flagship (B = 1, N = 6, D = 112, 16 x 44
// features, C = 128, 128 x 128 x 16 voxels), the function's inputs read
// once and its output written once: depth 1.9 MB (float32 under autocast),
// ctx 1.1 MB (bf16), the points' voxel coordinates 5.7 MB and validity
// 0.5 MB, and 134 MB of float32 volume: about 0.043 ms at 3.35 TB/s.  The
// sort and offsets add 6 MB of int64 that the kernel reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename Td, typename Tc>
__global__ void voxel_splat_kernel(const Td* __restrict__ depth,
                                   const Tc* __restrict__ ctx,
                                   const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ offs,
                                   float* __restrict__ out, int64_t n_out,
                                   int C, int D, int HW) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const int64_t r = i / C;
    const int c = (int)(i - r * C);
    const int64_t end = offs[r + 1];
    float acc = 0.f;
    for (int64_t j = offs[r]; j < end; ++j) {
      const int64_t p = order[j];
      const int64_t bn = p / ((int64_t)D * HW);
      const int64_t pix = bn * HW + p % HW;
      acc = fmaf(load_f(depth + p), load_f(ctx + pix * C + c), acc);
    }
    out[i] = acc;
  }
}

template <typename Td, typename Tc>
static void launch(const void* depth, const void* ctx, const void* order,
                   const void* offs, void* out, int64_t n_out, int C, int D,
                   int HW, cudaStream_t st) {
  const int threads = 256;
  int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  voxel_splat_kernel<Td, Tc><<<(unsigned)blocks, threads, 0, st>>>(
      (const Td*)depth, (const Tc*)ctx, (const int64_t*)order,
      (const int64_t*)offs, (float*)out, n_out, C, D, HW);
}

// Plain C entry point, loaded with ctypes.  depth [B, N, D, fH, fW] and ctx
// [B, N, fH, fW, C], each float32 (dtype 0) or bfloat16 (dtype 1); order
// int64 [B * N * D * fH * fW], the points sorted by voxel; offs int64
// [n_rows + 1], voxel r's points at order[offs[r] .. offs[r + 1]); out
// float32 [n_rows, C], written in full.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a bad dtype.
extern "C" int voxel_splat(const void* depth, const void* ctx,
                           const void* order, const void* offs, void* out,
                           long long n_rows, int C, int D, int HW,
                           int depth_dtype, int ctx_dtype, void* stream) {
  const int64_t n_out = (int64_t)n_rows * C;
  if (n_out == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int code = depth_dtype * 2 + ctx_dtype;
  if (depth_dtype < 0 || depth_dtype > 1 || ctx_dtype < 0 || ctx_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (code == 0)
    launch<float, float>(depth, ctx, order, offs, out, n_out, C, D, HW, st);
  else if (code == 1)
    launch<float, __nv_bfloat16>(depth, ctx, order, offs, out, n_out, C, D,
                                 HW, st);
  else if (code == 2)
    launch<__nv_bfloat16, float>(depth, ctx, order, offs, out, n_out, C, D,
                                 HW, st);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(depth, ctx, order, offs, out, n_out,
                                         C, D, HW, st);
  return (int)cudaGetLastError();
}
