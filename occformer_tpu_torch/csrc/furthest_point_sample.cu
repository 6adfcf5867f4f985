// Furthest-point sampling (FPS): the greedy sample of `npoint` indices of
// each cloud, each the point farthest from those already taken.
//
// Port of occformer_tpu/ops/pointcloud.py:furthest_point_sample (:161),
// which the JAX package runs as a lax.fori_loop of npoint steps (no Pallas
// kernel).  In plain PyTorch each step is several launches (a distance, a
// minimum, an argmax), so the loop costs npoint times their launch floor.
//
//   idx[b, 0] = 0
//   dist[b, i] = BIG for a valid point, -1 for an invalid one
//   step s = 1 .. npoint - 1:
//     last = idx[b, s - 1]
//     d = (dx * dx + dy * dy) + dz * dz,  (dx, dy, dz) = xyz[b, i] - xyz[b, last]
//     dist[b, i] = min(dist[b, i], d)
//     idx[b, s] = argmax_i dist[b, i], the lowest index among ties
//
// An invalid point keeps -1 and is never taken while a valid one is left
// (the JAX op adds BIG to an invalid point's distance, which makes it the
// farthest: its masked clouds return the first invalid point over and
// over; the port does not copy that fault).  Every distance is rounded as
// the plain version (ops/pointcloud.py:furthest_point_sample_plain) rounds
// it, each product and sum on its own (__fmul_rn / __fadd_rn / __fsub_rn:
// no FMA contraction), so the two take the same indices bit for bit.
//
// Design: one block of FPS_THREADS threads per cloud.  Thread t owns points
// t, t + FPS_THREADS, ... and keeps their running minimum distances in
// registers (PT of them; clouds over 32 * FPS_THREADS points keep them in a
// global workspace instead).  Each step every thread reads the last point
// (one broadcast load), updates its distances, takes its own best (value,
// lowest index), and the block reduces those by warp shuffles and one pass
// over the warps' results in shared memory: two barriers a step.  A step's
// latency, not the memory, bounds it: the loop is sequential and B blocks
// occupy B of the card's SMs.
//
// Bound on an H100 SXM at VoteNet's SA1 on ScanNet ([8, 20000, 3] -> 2048):
// 9 float32 operations a point a step (3 subtractions, 3 products, 2 sums, a
// minimum), 8 * 20000 * 2047 * 9 = 2.95 GFLOP at 67 TFLOP/s, 0.044 ms; the
// bytes (1.92 MB of points read, 66 KB of indices written) take 0.0006 ms.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

constexpr int FPS_THREADS = 1024;
constexpr float FPS_BIG = 1e10f;

__device__ __forceinline__ float fps_dist(const float* __restrict__ p, int i, float lx, float ly,
                                          float lz) {
  const float dx = __fsub_rn(__ldg(p + 3 * (int64_t)i + 0), lx);
  const float dy = __fsub_rn(__ldg(p + 3 * (int64_t)i + 1), ly);
  const float dz = __fsub_rn(__ldg(p + 3 * (int64_t)i + 2), lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (v, i) replaces (best, besti) when larger, or equal with a lower index.
__device__ __forceinline__ void fps_take(float v, int i, float& best, int& besti) {
  if (v > best || (v == best && i < besti)) {
    best = v;
    besti = i;
  }
}

// PT > 0: each thread's PT distances in registers; PT == 0: in ws.
template <int PT>
__global__ void __launch_bounds__(FPS_THREADS)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           float* __restrict__ ws, int* __restrict__ out, int N, int npoint) {
  __shared__ float warp_best[FPS_THREADS / 32];
  __shared__ int warp_idx[FPS_THREADS / 32];
  __shared__ int s_last;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + (int64_t)b * N * 3;
  const uint8_t* v = valid ? valid + (int64_t)b * N : nullptr;
  float* dws = PT == 0 ? ws + (int64_t)b * N : nullptr;
  int* o = out + (int64_t)b * npoint;
  float dist[PT > 0 ? PT : 1];
  if (PT > 0) {
#pragma unroll
    for (int k = 0; k < (PT > 0 ? PT : 1); ++k) {
      const int i = tid + k * FPS_THREADS;
      dist[k] = i < N ? (v && !v[i] ? -1.f : FPS_BIG) : -INFINITY;
    }
  } else {
    for (int i = tid; i < N; i += FPS_THREADS) dws[i] = v && !v[i] ? -1.f : FPS_BIG;
  }
  if (tid == 0 && npoint > 0) o[0] = 0;
  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float lx = __ldg(p + 3 * (int64_t)last + 0);
    const float ly = __ldg(p + 3 * (int64_t)last + 1);
    const float lz = __ldg(p + 3 * (int64_t)last + 2);
    float best = -INFINITY;
    int besti = INT_MAX;
    if (PT > 0) {
#pragma unroll
      for (int k = 0; k < (PT > 0 ? PT : 1); ++k) {
        const int i = tid + k * FPS_THREADS;
        if (i < N) {
          dist[k] = fminf(dist[k], fps_dist(p, i, lx, ly, lz));
          fps_take(dist[k], i, best, besti);
        }
      }
    } else {
      for (int i = tid; i < N; i += FPS_THREADS) {
        const float d = fminf(dws[i], fps_dist(p, i, lx, ly, lz));
        dws[i] = d;
        fps_take(d, i, best, besti);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      fps_take(ov, oi, best, besti);
    }
    if (lane == 0) {
      warp_best[warp] = best;
      warp_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_best[lane];  // FPS_THREADS / 32 == 32 warps
      besti = warp_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, besti, off);
        fps_take(ov, oi, best, besti);
      }
      if (lane == 0) {
        s_last = besti;
        o[s] = besti;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

// Float32s of fps's workspace for B clouds of N points: none when the
// distances fit in registers, else B * N.
extern "C" long long furthest_point_sample_workspace(int B, int N) {
  return N > 32 * FPS_THREADS ? (long long)B * N : 0;
}

// Plain C entry point, loaded with ctypes.  xyz float32 [B, N, 3]
// contiguous; valid bool [B, N] or null (every point valid); out int32 [B,
// npoint]; workspace furthest_point_sample_workspace(B, N) float32s (null
// when that is 0).  N at least 1.  Launches on `stream` and returns the
// first CUDA error, or cudaErrorInvalidValue for anything else.
extern "C" int furthest_point_sample(const void* xyz, const void* valid, void* out,
                                     void* workspace, int B, int N, int npoint, void* stream) {
  if (B < 0 || N < 1 || npoint < 0 || (N > 32 * FPS_THREADS && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || npoint == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)xyz;
  const uint8_t* v = (const uint8_t*)valid;
  float* ws = (float*)workspace;
  int* o = (int*)out;
  const int per = (N + FPS_THREADS - 1) / FPS_THREADS;
  if (per <= 1)
    fps_kernel<1><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else if (per <= 2)
    fps_kernel<2><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else if (per <= 4)
    fps_kernel<4><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else if (per <= 8)
    fps_kernel<8><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else if (per <= 16)
    fps_kernel<16><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else if (per <= 32)
    fps_kernel<32><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  else
    fps_kernel<0><<<B, FPS_THREADS, 0, st>>>(p, v, ws, o, N, npoint);
  return (int)cudaGetLastError();
}
