// The backend viability probe's two kernels (P1, P2).
//
// Replace the TPU kernels of tools/probe_pallas_viability.py: the trivial
// kernel add_one (:36, pallas_call :41), y = x + 1, and the dynamic row
// gather gather_kernel (:58, pallas_call :67), out[s, :] = table[idx[s], :].
// Their point is the path every kernel of the port takes (nvcc -> sm_90a ->
// a plain C interface -> ctypes), so they stay simple.
//
// P1: one thread per element.  P2: one warp per output row, 16-byte loads
// and stores along the row when its width is a multiple of 4 floats (the
// probe's 128 floats are one float4 per lane), else one float per lane and
// step; an index outside [0, N) writes a row of zeros.  Both are
// memory-bound on an H100 SXM: P1 reads and writes 4 KB at the probe's
// [8, 128], P2 reads the rows its indices name and writes 1 MB at
// [1024, 128] x 2048 rows, well under a microsecond at 3.35 TB/s, so launch
// latency sets their time.  empty_kernel does nothing: its device time is
// the card's launch floor, the least time any kernel takes, which a
// kernel's bound cannot go below.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.f;
}

__global__ void empty_kernel() {}

__global__ void row_gather_kernel(const float* __restrict__ table,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int N, int C,
                                  int S) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= S) return;
  const int r = idx[row];
  const bool ok = r >= 0 && r < N;
  float* dst = out + row * C;
  const float* src = table + (int64_t)(ok ? r : 0) * C;
  if (C % 4 == 0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = lane; c < C / 4; c += 32)
      reinterpret_cast<float4*>(dst)[c] =
          ok ? reinterpret_cast<const float4*>(src)[c] : zero;
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = ok ? src[c] : 0.f;
  }
}

// Plain C entry points, loaded with ctypes; device pointers, float32
// tensors, int32 indices.  Each launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int probe_add_one(const void* x, void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  add_one_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

// table [N, C], idx [S], out [S, C]; the rows are 16-byte aligned when C is
// a multiple of 4 (the caller's tensors start 16-byte aligned).
extern "C" int probe_row_gather(const void* table, const void* idx, void* out,
                                int N, int C, int S, void* stream) {
  if (S == 0 || C == 0) return 0;
  const int threads = 256;  // 8 rows per block
  const unsigned blocks = (unsigned)(((int64_t)S * 32 + threads - 1) / threads);
  row_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)idx, (float*)out, N, C, S);
  return (int)cudaGetLastError();
}

// One block of one thread that does nothing (the launch floor).
extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
