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
// What bounds it: the npoint - 1 steps depend on each other, so a step's
// latency, not the card's rates, sets the time.  The first design gave each
// cloud one block of 1024 threads: 8 SMs of 132 worked at [8, 20000], each
// thread reloaded its ~20 points' coordinates every step (64 registers a
// thread cannot hold them), and a step was a dependent load of the last
// point, two block barriers and a serial pass of warp 0: 3.77 us a step.
//
// Design: a thread-block cluster of CL CTAs (1-16, on neighbouring SMs of
// one GPC) per cloud; CTA r owns the slice [r * per_cta, (r + 1) * per_cta).
// Each thread keeps its PT points' coordinates and running minimum
// distances in registers (points t, t + T, ... of the slice), so no
// coordinate is read from memory inside the loop.  A step:
//   1. each thread updates its distances and takes its best (value, lowest
//      index, x, y, z);
//   2. each warp reduces those with two redux.sync (max of the value as an
//      ordered key, min of the index among the maxima) and one shuffle of
//      the winner's coordinates, and lanes 0 .. CL - 1 write the warp's
//      candidate into slot (rank, warp) of every CTA of the cluster
//      (distributed shared memory), double-buffered by the step's parity;
//   3. one cluster barrier (barrier.cluster.arrive.release /
//      wait.acquire), which also orders the slots' reads of two steps
//      back before their next writes;
//   4. every warp of every CTA reduces the CL * W candidates in its own
//      shared memory with the same rule and reads the winner's coordinates
//      from the winning slot: the next step starts without a global load.
// The (max value, lowest index) rule is associative and commutative, so the
// indices depend neither on CL nor on how the cloud is split.  Clouds whose
// slices exceed FPS_MAX_THREADS * FPS_MAX_PT points keep their distances in
// a global workspace and read their coordinates each step (PT == 0).
//
// Launch: cudaLaunchKernelEx with the cluster dimension.  A larger cluster
// shortens step 1 and lengthens step 3, so the launcher takes the smallest
// CL in {1, 2, 4, 8, 16} whose slices hold at most FPS_TARGET_POINTS points
// (8 a thread) and whose B clusters are resident at once with one CTA per
// SM (cudaOccupancyMaxActiveClusters, each CTA asking for enough shared
// memory that no second one fits on its SM); failing that the largest
// resident CL; failing that (more clouds than the card holds at once) the
// smallest CL whose slices fit in registers, CTAs packed.  A forced cluster
// size (the entry point's `cluster` argument) is launched as it is, and a
// refused launch returns its error.
//
// Measured at [8, 20000, 3] -> 2048 (tools/time_backwards.py --only FPS
// --sweep, H100 80GB HBM3 at 700 W, device ms): the block per cloud of the
// first design 6.91 (3.38 us a step); clusters of 4, 8 and 16 CTAs 2.81,
// 2.61 and 3.64 (1.37, 1.28 and 1.78 us a step); 1 and 2 CTAs, whose
// slices take the workspace, 29.6 and 16.1.
//
// Bound on an H100 SXM at VoteNet's SA1 on ScanNet ([8, 20000, 3] -> 2048):
// 9 float32 operations a point a step (3 subtractions, 3 products, 2 sums, a
// minimum), 8 * 20000 * 2047 * 9 = 2.95 GFLOP at 67 TFLOP/s, 0.044 ms; the
// bytes (1.92 MB of points read, 66 KB of indices written) take 0.0006 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int FPS_MAX_THREADS = 512;  // threads of a CTA
constexpr int FPS_MAX_PT = 16;        // points a thread keeps in registers
constexpr int FPS_MAX_CLUSTER = 16;   // CTAs of a cluster (above 8: non-portable)
constexpr int FPS_REG_POINTS = FPS_MAX_THREADS * FPS_MAX_PT;  // a slice in registers
constexpr int FPS_TARGET_POINTS = FPS_MAX_THREADS * 8;        // the slice the launcher seeks
constexpr int FPS_SLOTS = FPS_MAX_CLUSTER * FPS_MAX_THREADS / 32;  // candidates a step
// the slots: (key, index) and (x, y, z, -) of each candidate, two buffers
constexpr size_t FPS_SLOT_BYTES = 2 * FPS_SLOTS * (sizeof(uint2) + sizeof(float4));
// shared memory a CTA asks for so that no second CTA fits on its SM (228 KB
// an SM, 1 KB reserved a CTA)
constexpr size_t FPS_SPREAD_BYTES = 116 * 1024;
constexpr float FPS_BIG = 1e10f;
constexpr unsigned FPS_FULL = 0xffffffffu;

__device__ __forceinline__ float fps_dist(float x, float y, float z, float lx, float ly,
                                          float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A float's bits as an unsigned key of the same order (no NaN arises).
__device__ __forceinline__ unsigned fps_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// PT > 0: each thread's PT points in registers; PT == 0: distances in ws.
template <int PT>
__global__ void __launch_bounds__(FPS_MAX_THREADS)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           float* __restrict__ ws, int* __restrict__ out, int N, int npoint, int per_cta) {
  extern __shared__ __align__(16) unsigned char fps_smem[];
  uint2* cand = reinterpret_cast<uint2*>(fps_smem);                  // [2][FPS_SLOTS]
  float4* cpos = reinterpret_cast<float4*>(cand + 2 * FPS_SLOTS);    // [2][FPS_SLOTS]
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cand = CL * (T >> 5);
  const float* p = xyz + (int64_t)b * N * 3;
  const uint8_t* v = valid ? valid + (int64_t)b * N : nullptr;
  float* dws = PT == 0 ? ws + (int64_t)b * N : nullptr;
  int* o = out + (int64_t)b * npoint;
  const int beg = min(N, rank * per_cta), end = min(N, beg + per_cta);
  constexpr int R = PT > 0 ? PT : 1;
  float px[R], py[R], pz[R], dist[R];
  if (PT > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = beg + tid + k * T;
      const bool in = i < end;
      px[k] = in ? __ldg(p + 3 * (int64_t)i + 0) : 0.f;
      py[k] = in ? __ldg(p + 3 * (int64_t)i + 1) : 0.f;
      pz[k] = in ? __ldg(p + 3 * (int64_t)i + 2) : 0.f;
      dist[k] = in ? (v && !v[i] ? -1.f : FPS_BIG) : -INFINITY;
    }
  } else {
    for (int i = beg + tid; i < end; i += T) dws[i] = v && !v[i] ? -1.f : FPS_BIG;
  }
  if (rank == 0 && tid == 0 && npoint > 0) o[0] = 0;
  float lx = __ldg(p + 0), ly = __ldg(p + 1), lz = __ldg(p + 2);
  // every CTA of the cluster runs before any writes another's shared memory
  cluster.sync();
  for (int s = 1; s < npoint; ++s) {
    // 1. this thread's best (value, lowest index, coordinates)
    float best = -INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
    unsigned bi = 0xffffffffu;
    if (PT > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float d = fminf(dist[k], fps_dist(px[k], py[k], pz[k], lx, ly, lz));
        dist[k] = d;
        if (d > best) {  // ascending indices: a tie keeps the lower one
          best = d;
          bi = (unsigned)(beg + tid + k * T);
          bx = px[k];
          by = py[k];
          bz = pz[k];
        }
      }
    } else {
      for (int i = beg + tid; i < end; i += T) {
        const float x = __ldg(p + 3 * (int64_t)i + 0), y = __ldg(p + 3 * (int64_t)i + 1),
                    z = __ldg(p + 3 * (int64_t)i + 2);
        const float d = fminf(dws[i], fps_dist(x, y, z, lx, ly, lz));
        dws[i] = d;
        if (d > best) {
          best = d;
          bi = (unsigned)i;
          bx = x;
          by = y;
          bz = z;
        }
      }
    }
    // 2. the warp's candidate, written into slot (rank, warp) of every CTA
    const unsigned key = fps_key(best);
    const unsigned wk = __reduce_max_sync(FPS_FULL, key);
    const unsigned wi = __reduce_min_sync(FPS_FULL, key == wk ? bi : 0xffffffffu);
    const int src = __ffs(__ballot_sync(FPS_FULL, key == wk && bi == wi)) - 1;
    const float wx = __shfl_sync(FPS_FULL, bx, src);
    const float wy = __shfl_sync(FPS_FULL, by, src);
    const float wz = __shfl_sync(FPS_FULL, bz, src);
    const int buf = (s & 1) * FPS_SLOTS;
    const int slot = buf + rank * (T >> 5) + warp;
    if (lane < CL) {
      cluster.map_shared_rank(cand, lane)[slot] = make_uint2(wk, wi);
      cluster.map_shared_rank(cpos, lane)[slot] = make_float4(wx, wy, wz, 0.f);
    }
    // 3. every candidate of the step is in every CTA
    cluster_barrier();
    // 4. the step's winner, by every warp from its CTA's slots
    unsigned ck = 0u, ci = 0xffffffffu;
    int cj = 0;
    for (int j = lane; j < n_cand; j += 32) {
      const uint2 c = cand[buf + j];
      if (c.x > ck || (c.x == ck && c.y < ci)) {
        ck = c.x;
        ci = c.y;
        cj = j;
      }
    }
    const unsigned gk = __reduce_max_sync(FPS_FULL, ck);
    const unsigned gi = __reduce_min_sync(FPS_FULL, ck == gk ? ci : 0xffffffffu);
    const int gj = __shfl_sync(FPS_FULL, cj,
                               __ffs(__ballot_sync(FPS_FULL, ck == gk && ci == gi)) - 1);
    const float4 w = cpos[buf + gj];
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (rank == 0 && tid == 0) o[s] = (int)gi;
  }
}

struct FpsArgs {
  const float* xyz;
  const uint8_t* valid;
  float* ws;
  int* out;
  int N, npoint, per_cta;
};

// Points a thread keeps in registers for a slice of `per_cta` points: the
// fewest of 1, 2, 4, 8, 16 that FPS_MAX_THREADS threads can hold, or 0 (the
// workspace) above FPS_REG_POINTS.
static int fps_points_per_thread(int per_cta) {
  for (int pt = 1; pt <= FPS_MAX_PT; pt *= 2)
    if ((per_cta + pt - 1) / pt <= FPS_MAX_THREADS) return pt;
  return 0;
}

static int fps_threads(int per_cta, int pt) {
  if (pt == 0) return FPS_MAX_THREADS;
  const int t = ((per_cta + pt - 1) / pt + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

// Launches fps_kernel<PT> over B clusters of CL CTAs of T threads with
// `smem` bytes of dynamic shared memory, or (active != null) stores in
// *active how many such clusters the card holds at once.
template <int PT>
static cudaError_t fps_run(const FpsArgs& a, int B, int CL, int T, size_t smem, int* active,
                           cudaStream_t st) {
  auto kernel = fps_kernel<PT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FPS_SPREAD_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * CL));
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active) return cudaOccupancyMaxActiveClusters(active, (const void*)kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, a.xyz, a.valid, a.ws, a.out, a.N, a.npoint,
                            a.per_cta);
}

static cudaError_t fps_dispatch(int pt, const FpsArgs& a, int B, int CL, int T, size_t smem,
                                int* active, cudaStream_t st) {
  switch (pt) {
    case 1: return fps_run<1>(a, B, CL, T, smem, active, st);
    case 2: return fps_run<2>(a, B, CL, T, smem, active, st);
    case 4: return fps_run<4>(a, B, CL, T, smem, active, st);
    case 8: return fps_run<8>(a, B, CL, T, smem, active, st);
    case 16: return fps_run<16>(a, B, CL, T, smem, active, st);
    default: return fps_run<0>(a, B, CL, T, smem, active, st);
  }
}

// Float32s of fps's workspace for B clouds of N points: none when every
// cluster size keeps the distances in registers, else B * N.
extern "C" long long furthest_point_sample_workspace(int B, int N) {
  return N > FPS_REG_POINTS ? (long long)B * N : 0;
}

// Plain C entry point, loaded with ctypes.  xyz float32 [B, N, 3]
// contiguous; valid bool [B, N] or null (every point valid); out int32 [B,
// npoint]; workspace furthest_point_sample_workspace(B, N) float32s (null
// when that is 0).  N at least 1.  cluster: the CTAs a cloud takes (1, 2,
// 4, 8 or 16), or 0 for the launcher's choice; *took (when not null)
// receives the size launched.  Launches on `stream` and returns the first
// CUDA error (a refused cluster launch included), or cudaErrorInvalidValue
// for anything else.
extern "C" int furthest_point_sample(const void* xyz, const void* valid, void* out,
                                     void* workspace, int B, int N, int npoint, int cluster,
                                     int* took, void* stream) {
  if (B < 0 || N < 1 || npoint < 0 || cluster < 0 || cluster > FPS_MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0 || (long long)B * FPS_MAX_CLUSTER > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (took) *took = 0;
  if (B == 0 || npoint == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  FpsArgs a{(const float*)xyz, (const uint8_t*)valid, (float*)workspace, (int*)out, N, npoint,
            0};
  int CL = cluster;
  size_t smem = FPS_SLOT_BYTES;
  if (CL == 0) {
    // cluster sizes whose B clusters are all resident, one CTA an SM
    bool resident[FPS_MAX_CLUSTER + 1] = {};
    for (int cl = 1; cl <= FPS_MAX_CLUSTER; cl *= 2) {
      const int per = (N + cl - 1) / cl, pt = fps_points_per_thread(per);
      int active = 0;
      cudaError_t err =
          fps_dispatch(pt, a, B, cl, fps_threads(per, pt), FPS_SPREAD_BYTES, &active, st);
      if (err != cudaSuccess) return (int)err;
      resident[cl] = active >= B;
    }
    for (int cl = 1; cl <= FPS_MAX_CLUSTER && CL == 0; cl *= 2)
      if (resident[cl] && (N + cl - 1) / cl <= FPS_TARGET_POINTS) CL = cl;
    for (int cl = FPS_MAX_CLUSTER; cl >= 1 && CL == 0; cl /= 2)
      if (resident[cl]) CL = cl;
    if (CL != 0) {
      smem = FPS_SPREAD_BYTES;
    } else {
      CL = FPS_MAX_CLUSTER;
      for (int cl = FPS_MAX_CLUSTER / 2; cl >= 1; cl /= 2)
        if ((N + cl - 1) / cl <= FPS_REG_POINTS) CL = cl;
    }
  } else {
    const int per = (N + CL - 1) / CL, pt = fps_points_per_thread(per);
    int active = 0;
    cudaError_t err =
        fps_dispatch(pt, a, B, CL, fps_threads(per, pt), FPS_SPREAD_BYTES, &active, st);
    if (err != cudaSuccess) return (int)err;
    if (active >= B) smem = FPS_SPREAD_BYTES;
  }
  a.per_cta = (N + CL - 1) / CL;
  const int pt = fps_points_per_thread(a.per_cta);
  if (pt == 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = fps_dispatch(pt, a, B, CL, fps_threads(a.per_cta, pt), smem, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  if (took) *took = CL;
  return (int)cudaGetLastError();
}
