// The LSS voxel splat (S1): the lifted depth x context features summed by
// voxel, in a fixed order; and S1-rows, the same sum of given feature rows.
//
// Port of occformer_tpu/ops/scatter.py:voxel_scatter_lifted (:55), which
// the JAX package leaves to XLA's scatter-add (no Pallas kernel; its sums
// repeat themselves run to run):
//
//   out[r, c] = sum over the valid frustum points p in voxel r of
//               depth[p] * ctx[pixel(p), c]
//
// with depth [B, N, D, fH, fW] (p = ((b * N + n) * D + d) * fH * fW + h * fW
// + w), ctx [B, N, fH, fW, C] (pixel(p) = (b * N + n) * fH * fW + h * fW +
// w), coords int32 [B, N, D, fH, fW, 3] each point's voxel (clamped into the
// grid, as ops/scatter.py:voxel_rows) and valid [B, N, D, fH, fW].  The sum
// is kept in float32 and stored once in depth's type.
//
// Why a kernel: index_add_ adds with float atomics in an order that changes
// from run to run, so two identical train steps differed in the last bits
// of their losses; PyTorch's deterministic index_add_ (a sort, then one
// serial sum per voxel) and a sort plus torch.segment_reduce took 300 and
// 46 device ms a frame at the flagship's shapes.
//
// Design.  The first design sorted the points by voxel around the
// kernel with torch.argsort, bincount and cumsum on int64 rows (about 1.3 of
// its 1.62 ms a call, every invalid point sorted into a dummy row), then ran
// one thread per (voxel, channel), 33.5 M threads at the flagship, each
// doing two 64-bit divisions and a 2-byte context load per point.  Here:
//   1-4. the counting sort of segment_sort.cuh with SplatKeys: one thread
//        per frustum point computes its voxel row in int32 from coords and
//        valid (an invalid point gets no entry) and counts it; the entries
//        are (pixel, depth) pairs, the pixel's row of ctx computed in int32
//        and the depth read as a float once per point, each voxel's in
//        ascending point order (the order torch.argsort(stable=True) gave,
//        so the sums keep their bits);
//   5.   the splat: one warp per SPLAT_GROUP consecutive voxels.  Lane l
//        owns channels l * VEC .. l * VEC + VEC - 1 (VEC = 4 at C = 128:
//        8-byte bf16 context loads, one float32 accumulator per channel).
//        The warp loads the group's offsets at once and streams the
//        entries of its light voxels (at most SPLAT_HEAVY entries each) 32
//        at a time, one a lane, across voxel boundaries, each lane issuing
//        the context loads of SPLAT_INFLIGHT entries (broadcast by shuffles)
//        before their FMAs, and stores each voxel's row once, an empty
//        voxel's as zeros.  A heavy voxel goes to a list; a second kernel
//        gives each listed voxel a warp of its own, so that the hot voxels
//        near a camera do not serialise a group.
// No float atomics: the same bits on every run.  The backward is gathers
// (ops/scatter.py).
//
// S1-rows (voxel_splat_rows below) is the port of
// occformer_tpu/ops/scatter.py:voxel_scatter (:20), a segment_sum of given
// rows that the JAX package leaves to XLA (no Pallas kernel), used by the
// view transformer's use_voxel_net branch, whose DepthAggregation convs
// leave no depth x context product to fuse:
//
//   out[r, c] = sum over the valid points p in voxel r of feats[p, c]
//
// with feats [B * P, C], coords int32 [B * P, 3] and valid [B * P].  It
// runs the same sort with RowKeys, whose entry is (p, 1.0f): the splat
// kernels then read point p's row of feats and add it in float32 (fmaf(1,
// v, acc) rounds as v + acc does), each voxel's points in ascending point
// order, the order of the plain version's index_add_ on the CPU, so the two
// agree bit for bit.  The light/heavy voxel split is S1's.  Its backward is
// a gather, d_feats[p] = g[row p] (ops/scatter.py).
//
// Bound on an H100 SXM at the use_voxel_net flagship (B = 1, P = 6 * 112 *
// 16 * 44 = 473,088 rows of C = 128 in bf16, 128 x 128 x 16 voxels, the
// nuScenes rig's 278,782 valid points): valid 0.47 MB read in full, the
// valid points' coords 3.35 MB and rows of feats 71.4 MB (RowKeys drops an
// invalid point before it reads either), the volume 67.1 MB written, 142.3
// MB, 0.042 ms at 3.35 TB/s (float32: 280.8 MB, 0.084 ms).
//
// Measured (tools/time_backwards.py --only S1, H100 80GB HBM3 at 700 W,
// device ms of the splat kernels, in turns in one call, the volume's bits
// unchanged throughout), at a forward-looking nuScenes rig (278,782 valid
// points in 108,468 voxels, the largest 168) / at the synthetic cameras
// that look straight up (11,264 in 88, the largest 382): a warp per voxel
// 0.155 / 0.067; the depth carried in the entry 0.153 / 0.051-0.071; a
// warp per 2, 4, 8 voxels 0.127, 0.083-0.085, 0.073-0.074 / 0.132, 0.199-
// 0.201, 0.194-0.195 (the hot voxels serialise their group); 8 voxels with
// voxels over 16 or 32 entries to the second kernel 0.073-0.075 / 0.061-
// 0.062; 16 voxels over 32 (kept) 0.065 / 0.060-0.061.
//
// Bound on an H100 SXM at the flagship (B = 1, N = 6, D = 112, 16 x 44
// features, C = 128, 128 x 128 x 16 voxels), in the dtypes it is sent (bf16
// depth and ctx under autocast, int32 coords, bool valid, a bf16 volume),
// the function's inputs read once and its output written once: depth 0.95 MB
// + ctx 1.08 MB + coords 5.68 MB + valid 0.47 MB + the volume 67.1 MB, 75.3
// MB, 0.0225 ms at 3.35 TB/s.  The sort's int32 workspace (offsets and
// cursor 1 MB each, 4 bytes of item index and 8 of entry a point, the
// heavy voxels' list 1 MB) adds traffic the bound does not count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chunk_io.cuh"
#include "segment_sort.cuh"

// The sort key of frustum point p: its voxel row b * X*Y*Z + (x * Y + y) * Z
// + z when valid, none otherwise; its entry (its pixel's row of ctx,
// depth[p] as a float's bits).
struct SplatKeys {
  using Entry = int2;
  const int* coords;
  const uint8_t* valid;
  int X, Y, Z, D, HW, per_batch;  // per_batch = N * D * HW points
  const void* depth;
  int depth_bf16;
  template <typename Fn>
  __device__ __forceinline__ void operator()(int64_t i, Fn fn) const {
    const int p = (int)i;
    if (!valid[p]) return;
    const int x = min(max(coords[3 * p + 0], 0), X - 1);
    const int y = min(max(coords[3 * p + 1], 0), Y - 1);
    const int z = min(max(coords[3 * p + 2], 0), Z - 1);
    fn((int64_t)(p / per_batch) * X * Y * Z + (x * Y + y) * Z + z);
  }
  __device__ __forceinline__ int2 entry(int64_t i) const {
    const int p = (int)i;
    const float d = depth_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(depth)[p])
                               : static_cast<const float*>(depth)[p];
    return make_int2(p / (D * HW) * HW + p % HW, __float_as_int(d));
  }
};

// The sort key of row p of S1-rows: its voxel row b * X*Y*Z + (x * Y + y) *
// Z + z when valid, none otherwise; its entry (p, 1.0f as a float's bits).
struct RowKeys {
  using Entry = int2;
  const int* coords;
  const uint8_t* valid;
  int X, Y, Z, P;
  template <typename Fn>
  __device__ __forceinline__ void operator()(int64_t i, Fn fn) const {
    const int p = (int)i;
    if (!valid[p]) return;
    const int x = min(max(coords[3 * p + 0], 0), X - 1);
    const int y = min(max(coords[3 * p + 1], 0), Y - 1);
    const int z = min(max(coords[3 * p + 2], 0), Z - 1);
    fn((int64_t)(p / P) * X * Y * Z + (x * Y + y) * Z + z);
  }
  __device__ __forceinline__ int2 entry(int64_t i) const {
    return make_int2((int)i, __float_as_int(1.0f));
  }
};

// Entries whose context loads a lane issues before their FMAs.
constexpr int SPLAT_INFLIGHT = 16;
constexpr int SPLAT_GROUP = 16;
constexpr int SPLAT_HEAVY = 32;
constexpr int SPLAT_HEAVY_BLOCKS = 512;

// The entries [beg, end) of one voxel, in order, into acc (lane's channels
// c .. c + VEC - 1).
template <typename Tc, int VEC>
__device__ __forceinline__ void splat_run(const Tc* __restrict__ ctx,
                                          const int2* __restrict__ sorted, int beg, int end,
                                          int C, int c, bool on, float (&acc)[VEC]) {
  using RawC = typename Raw<VEC * sizeof(Tc)>::T;
  const int lane = threadIdx.x & 31;
  for (int t0 = beg; t0 < end; t0 += 32) {
    const int t = t0 + lane;
    const int2 e = t < end ? sorted[t] : make_int2(0, 0);
    const int nb = min(32, end - t0);
    for (int j0 = 0; j0 < nb; j0 += SPLAT_INFLIGHT) {
      RawC v[SPLAT_INFLIGHT];
      float dj[SPLAT_INFLIGHT];
#pragma unroll
      for (int k = 0; k < SPLAT_INFLIGHT; ++k) {
        const bool in = j0 + k < nb;
        const int pix = __shfl_sync(0xffffffffu, e.x, in ? j0 + k : 0);
        dj[k] = __int_as_float(__shfl_sync(0xffffffffu, e.y, in ? j0 + k : 0));
        v[k] = on && in ? __ldg(reinterpret_cast<const RawC*>(ctx + (int64_t)pix * C + c))
                        : RawC{};
      }
#pragma unroll
      for (int k = 0; k < SPLAT_INFLIGHT; ++k)
        if (j0 + k < nb) fma_chunk<Tc, VEC>(acc, v[k], dj[k]);
    }
  }
}

// ROWS: 0 for S1, 1 for S1-rows (only the kernels' names differ)
template <typename Td, typename Tc, int VEC, int ROWS>
__global__ void __launch_bounds__(256)
voxel_splat_kernel(const Tc* __restrict__ ctx, const int* __restrict__ offs,
                   const int2* __restrict__ sorted, Td* __restrict__ out,
                   int* __restrict__ heavy_list, int* __restrict__ n_heavy, int64_t n_rows,
                   int C) {
  using RawC = typename Raw<VEC * sizeof(Tc)>::T;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * SPLAT_GROUP;
  if (r0 >= n_rows) return;
  const int nv = (int)min((int64_t)SPLAT_GROUP, n_rows - r0);
  const int my_off = lane <= nv ? offs[r0 + lane] : 0;
  const int next_off = __shfl_down_sync(0xffffffffu, my_off, 1);
  const bool is_heavy = lane < nv && next_off - my_off > SPLAT_HEAVY;
  const unsigned heavy = __ballot_sync(0xffffffffu, is_heavy);
  if (is_heavy) heavy_list[atomicAdd(n_heavy, 1)] = (int)(r0 + lane);
  const int gend = __shfl_sync(0xffffffffu, my_off, nv);
  const int passes = (C + 32 * VEC - 1) / (32 * VEC);
  for (int pass = 0; pass < passes; ++pass) {
    const int c = (pass * 32 + lane) * VEC;
    const bool on = c < C;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int v = 0;
    int vend = __shfl_sync(0xffffffffu, my_off, 1);
    int t = __shfl_sync(0xffffffffu, my_off, 0);
    while (true) {
      // leave the voxels that are done (stored) and the heavy ones (skipped)
      while (v < nv && (t >= vend || ((heavy >> v) & 1u))) {
        if ((heavy >> v) & 1u) {
          t = vend;
        } else if (on) {
          store_chunk<Td, VEC>(out + (r0 + v) * C + c, acc);
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
        ++v;
        vend = __shfl_sync(0xffffffffu, my_off, v + 1);
      }
      if (v >= nv) break;
      // a run of light voxels' entries up to the next heavy voxel
      const unsigned hm = heavy & ~((1u << v) - 1u);
      const int run_end = __shfl_sync(0xffffffffu, my_off, hm ? __ffs(hm) - 1 : nv);
      const int nb = min(32, run_end - t);
      const int2 e = lane < nb ? sorted[t + lane] : make_int2(0, 0);
      for (int j0 = 0; j0 < nb; j0 += SPLAT_INFLIGHT) {
        RawC vv[SPLAT_INFLIGHT];
        float dj[SPLAT_INFLIGHT];
#pragma unroll
        for (int k = 0; k < SPLAT_INFLIGHT; ++k) {
          const bool in = j0 + k < nb;
          const int pix = __shfl_sync(0xffffffffu, e.x, in ? j0 + k : 0);
          dj[k] = __int_as_float(__shfl_sync(0xffffffffu, e.y, in ? j0 + k : 0));
          vv[k] = on && in ? __ldg(reinterpret_cast<const RawC*>(ctx + (int64_t)pix * C + c))
                           : RawC{};
        }
#pragma unroll
        for (int k = 0; k < SPLAT_INFLIGHT; ++k) {
          if (j0 + k >= nb) break;
          while (t + j0 + k >= vend) {  // a light voxel is done: store it
            if (on) store_chunk<Td, VEC>(out + (r0 + v) * C + c, acc);
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
            ++v;
            vend = __shfl_sync(0xffffffffu, my_off, v + 1);
          }
          fma_chunk<Tc, VEC>(acc, vv[k], dj[k]);
        }
      }
      t += nb;
    }
  }
}

template <typename Td, typename Tc, int VEC, int ROWS>
__global__ void __launch_bounds__(256)
voxel_splat_heavy_kernel(const Tc* __restrict__ ctx, const int* __restrict__ offs,
                         const int2* __restrict__ sorted, Td* __restrict__ out,
                         const int* __restrict__ heavy_list, const int* __restrict__ n_heavy,
                         int C) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int n = *n_heavy;
  const int passes = (C + 32 * VEC - 1) / (32 * VEC);
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < n; i += warps) {
    const int64_t r = heavy_list[i];
    const int beg = offs[r], end = offs[r + 1];
    for (int pass = 0; pass < passes; ++pass) {
      const int c = (pass * 32 + lane) * VEC;
      const bool on = c < C;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      splat_run<Tc, VEC>(ctx, sorted, beg, end, C, c, on, acc);
      if (on) store_chunk<Td, VEC>(out + r * C + c, acc);
    }
  }
}

template <typename Td, typename Tc, int VEC, int ROWS>
static void launch_splat_vec(const void* ctx, const int* offs, const int2* sorted, void* out,
                             int* heavy_list, int* n_heavy, int64_t n_rows, int C,
                             cudaStream_t st) {
  const int threads = 256;
  voxel_splat_kernel<Td, Tc, VEC, ROWS>
      <<<grid_blocks((n_rows + SPLAT_GROUP - 1) / SPLAT_GROUP * 32, threads), threads, 0, st>>>(
          (const Tc*)ctx, offs, sorted, (Td*)out, heavy_list, n_heavy, n_rows, C);
  voxel_splat_heavy_kernel<Td, Tc, VEC, ROWS><<<SPLAT_HEAVY_BLOCKS, threads, 0, st>>>(
      (const Tc*)ctx, offs, sorted, (Td*)out, heavy_list, n_heavy, C);
}

template <typename Td, typename Tc, int ROWS = 0>
static void launch_splat(const void* ctx, const int* offs, const int2* sorted, void* out,
                         int* heavy_list, int* n_heavy, int64_t n_rows, int C, int vec,
                         cudaStream_t st) {
  if (vec == 4)
    launch_splat_vec<Td, Tc, 4, ROWS>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C,
                                      st);
  else if (vec == 2)
    launch_splat_vec<Td, Tc, 2, ROWS>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C,
                                      st);
  else
    launch_splat_vec<Td, Tc, 1, ROWS>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C,
                                      st);
}

// Int32s of voxel_splat's workspace for B * X*Y*Z voxel rows and n_pts
// frustum points: segment_sort with one (pixel, depth) entry a point, then
// the heavy voxels' list and its count.
extern "C" long long voxel_splat_workspace(long long n_rows, long long n_pts) {
  return (long long)segment_sort_ints(n_rows, n_pts, 2) + n_rows + 2;
}

// Plain C entry point, loaded with ctypes.  depth [B, N, D, fH, fW] and ctx
// [B, N, fH, fW, C], each float32 (dtype 0) or bfloat16 (dtype 1); coords
// int32 [B, N, D, fH, fW, 3]; valid bool [B, N, D, fH, fW]; out [B * X * Y
// * Z, C] in depth's dtype, written in full; workspace
// voxel_splat_workspace(B * X * Y * Z, B * N * D * fH * fW) int32s, 8-byte
// aligned.  The points and rows below 2^31.  Launches on `stream` and
// returns the first CUDA error, or cudaErrorInvalidValue for anything else.
extern "C" int voxel_splat(const void* depth, const void* ctx, const void* coords,
                           const void* valid, void* out, void* workspace, int B, int N,
                           int D, int HW, int X, int Y, int Z, int C, int depth_dtype,
                           int ctx_dtype, void* stream) {
  const int64_t n_pts = (int64_t)B * N * D * HW;
  const int64_t n_rows = (int64_t)B * X * Y * Z;
  if (depth_dtype < 0 || depth_dtype > 1 || ctx_dtype < 0 || ctx_dtype > 1 ||
      n_pts >= ((int64_t)1 << 31) || n_rows + 1 >= ((int64_t)1 << 31) ||
      (uintptr_t)workspace % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || C == 0) return 0;
  // context loads as wide as the row and the alignments of ctx and out allow
  const int c_size = ctx_dtype ? 2 : 4, d_size = depth_dtype ? 2 : 4;
  int vec = 4;
  while (vec > 1 && (C % vec != 0 || (uintptr_t)ctx % (vec * c_size) != 0 ||
                     (uintptr_t)out % (vec * d_size) != 0))
    vec /= 2;
  cudaStream_t st = (cudaStream_t)stream;
  const auto s = segment_sort_space<int2>(workspace, n_rows, n_pts);
  const SplatKeys keys{(const int*)coords, (const uint8_t*)valid, X, Y, Z, D, HW,
                       N * D * HW, depth, depth_dtype};
  cudaError_t err = segment_sort(keys, n_pts, n_rows, s, st);
  if (err != cudaSuccess) return (int)err;
  int* heavy_list = reinterpret_cast<int*>(workspace) + segment_sort_ints(n_rows, n_pts, 2);
  int* n_heavy = heavy_list + n_rows;
  err = cudaMemsetAsync(n_heavy, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int code = depth_dtype * 2 + ctx_dtype;
  if (code == 0)
    launch_splat<float, float>(ctx, s.offs, s.sorted, out, heavy_list, n_heavy, n_rows, C, vec,
                               st);
  else if (code == 1)
    launch_splat<float, __nv_bfloat16>(ctx, s.offs, s.sorted, out, heavy_list, n_heavy, n_rows,
                                       C, vec, st);
  else if (code == 2)
    launch_splat<__nv_bfloat16, float>(ctx, s.offs, s.sorted, out, heavy_list, n_heavy, n_rows,
                                       C, vec, st);
  else
    launch_splat<__nv_bfloat16, __nv_bfloat16>(ctx, s.offs, s.sorted, out, heavy_list, n_heavy,
                                               n_rows, C, vec, st);
  return (int)cudaGetLastError();
}

// S1-rows, plain C entry point, loaded with ctypes.  feats [B * P, C] float32
// (dtype 0) or bfloat16 (dtype 1); coords int32 [B * P, 3]; valid bool
// [B * P]; out [B * X * Y * Z, C] in feats' dtype, written in full;
// workspace voxel_splat_workspace(B * X * Y * Z, B * P) int32s, 8-byte
// aligned.  The rows and voxels below 2^31.  Launches on `stream` and
// returns the first CUDA error, or cudaErrorInvalidValue for anything else.
extern "C" int voxel_splat_rows(const void* feats, const void* coords, const void* valid,
                                void* out, void* workspace, int B, int P, int X, int Y,
                                int Z, int C, int dtype, void* stream) {
  const int64_t n_pts = (int64_t)B * P;
  const int64_t n_rows = (int64_t)B * X * Y * Z;
  if (dtype < 0 || dtype > 1 || n_pts >= ((int64_t)1 << 31) ||
      n_rows + 1 >= ((int64_t)1 << 31) || (uintptr_t)workspace % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || C == 0) return 0;
  const int size = dtype ? 2 : 4;
  int vec = 4;
  while (vec > 1 && (C % vec != 0 || (uintptr_t)feats % (vec * size) != 0 ||
                     (uintptr_t)out % (vec * size) != 0))
    vec /= 2;
  cudaStream_t st = (cudaStream_t)stream;
  const auto s = segment_sort_space<int2>(workspace, n_rows, n_pts);
  const RowKeys keys{(const int*)coords, (const uint8_t*)valid, X, Y, Z, P};
  cudaError_t err = segment_sort(keys, n_pts, n_rows, s, st);
  if (err != cudaSuccess) return (int)err;
  int* heavy_list = reinterpret_cast<int*>(workspace) + segment_sort_ints(n_rows, n_pts, 2);
  int* n_heavy = heavy_list + n_rows;
  err = cudaMemsetAsync(n_heavy, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    launch_splat<float, float, 1>(feats, s.offs, s.sorted, out, heavy_list, n_heavy, n_rows, C,
                                  vec, st);
  else
    launch_splat<__nv_bfloat16, __nv_bfloat16, 1>(feats, s.offs, s.sorted, out, heavy_list,
                                                  n_heavy, n_rows, C, vec, st);
  return (int)cudaGetLastError();
}
