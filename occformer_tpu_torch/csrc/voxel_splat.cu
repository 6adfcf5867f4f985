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
// No float atomics: the same bits on every run.  The backward is S1-bwd
// (voxel_splat_bwd below).
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
//
// S1-rows (voxel_splat_rows below) is the port of
// occformer_tpu/ops/scatter.py:voxel_scatter (:20), a segment_sum of given
// rows that the JAX package leaves to XLA (no Pallas kernel), used by the
// view transformer's use_voxel_net branch, whose DepthAggregation convs
// leave no depth x context product to fuse:
//
//   out[r, c] = sum over the valid points p in voxel r of feats[p, c]
//
// with feats [B * P, C], coords int32 [B * P, 3] and valid [B * P], each
// voxel's rows added in float32 in ascending point order (no float
// atomics), the order of the plain version's index_add_ on the CPU, so the
// two agree bit for bit and two calls give the same bits.  Its backward is
// S1-rows-bwd (voxel_splat_rows_bwd below), a gather d_feats[p] = g[row p].
//
// Bound on an H100 SXM at the use_voxel_net flagship (B = 1, P = 6 * 112 *
// 16 * 44 = 473,088 rows of C = 128 in bf16, 128 x 128 x 16 voxels, the
// nuScenes rig's 278,782 valid points): valid 0.47 MB read in full, the
// valid points' coords 3.35 MB and rows of feats 71.4 MB, the volume 67.1 MB
// written, 142.3 MB, 0.042 ms at 3.35 TB/s (float32: 280.8 MB, 0.084 ms).
//
// Its first design ran S1's sort and splat with an entry (p, 1.0f), ten
// launches; at that shape, bf16 (tools/time_backwards.py --only S1-rows,
// H100 80GB HBM3 at 700 W, device us): the offsets' memset 2.1, count 6.6,
// the scan's three launches 7.6, fill 9.6, the O(L^2) rank 11.9, the splat
// 90.9 and its heavy-voxel kernel 27.7: 157 us, 76% of it the splat, whose
// warps waited on three dependent loads (offsets, entries, 16 rows at a
// time) for a few rows each, and on one warp for each voxel of over 32
// rows.  Now six launches (rows_* below), all with 4-byte entries:
//   1. one memset: the counts, the scan's tile words and ticket, the splat
//      blocks' first voxels;
//   2. rows_count_kernel: a thread per point stores its key (voxel row, or
//      -1 when invalid) and counts it, one int32 atomic per group of equal
//      keys in the warp (__match_any_sync: consecutive depth bins of a ray
//      mostly share a voxel);
//   3. rows_scan_kernel: the exclusive scan of the counts in one launch,
//      decoupled look-back over SCAN_TILE-count tiles, also the fill's
//      cursor;
//   4. rows_fill_kernel: a thread per point takes a slot of its voxel's span
//      by one atomic per group of equal keys (a group's slots ascend with
//      its points, the groups' order is the atomics'); a thread per voxel
//      marks where each splat block starts (below);
//   5. rows_rank_kernel: a thread per valid point counts its span's points
//      below it and writes itself at that rank (O(L^2) over a span of L,
//      mostly L1 hits; writing the spans that are one warp group's straight
//      from the fill saved nothing);
//   6. rows_splat_kernel: the voxels cut into runs of at most ROWS_MAX_COST
//      voxels plus rows (so a hot voxel shares no block with many others and
//      empty stretches share theirs), a block of ROWS_THREADS per run.  The
//      run's rows are one stretch of the sorted entries, gathered in stages
//      of ROWS_STAGE rows by 16-byte cp.async (other rows by plain loads)
//      into a ring of ROWS_STAGES stages in shared memory, the next stage in
//      flight while the warps add the current one.  Each warp owns groups
//      of 32 voxels, one voxel's span a lane, and adds each voxel's rows
//      from shared memory in entry order, ROWS_UNROLL at a time; it stores
//      each row once, an empty voxel's as zeros.  A voxel whose rows span
//      stages keeps its sum in registers, so a hot voxel needs no second
//      kernel.
// Two splats lost to this one on the card: a block per 64 voxels gathering
// each row by one cp.async.bulk, its warps walking every voxel, and a block
// per SM over long runs with a deeper ring, which got slower as the ring
// deepened (the next stage's cp.async stalled on the memory system while
// the current one's rows were long in).

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

template <typename Td, typename Tc, int VEC>
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

template <typename Td, typename Tc, int VEC>
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

template <typename Td, typename Tc, int VEC>
static void launch_splat_vec(const void* ctx, const int* offs, const int2* sorted, void* out,
                             int* heavy_list, int* n_heavy, int64_t n_rows, int C,
                             cudaStream_t st) {
  const int threads = 256;
  voxel_splat_kernel<Td, Tc, VEC>
      <<<grid_blocks((n_rows + SPLAT_GROUP - 1) / SPLAT_GROUP * 32, threads), threads, 0, st>>>(
          (const Tc*)ctx, offs, sorted, (Td*)out, heavy_list, n_heavy, n_rows, C);
  voxel_splat_heavy_kernel<Td, Tc, VEC><<<SPLAT_HEAVY_BLOCKS, threads, 0, st>>>(
      (const Tc*)ctx, offs, sorted, (Td*)out, heavy_list, n_heavy, C);
}

template <typename Td, typename Tc>
static void launch_splat(const void* ctx, const int* offs, const int2* sorted, void* out,
                         int* heavy_list, int* n_heavy, int64_t n_rows, int C, int vec,
                         cudaStream_t st) {
  if (vec == 4)
    launch_splat_vec<Td, Tc, 4>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C, st);
  else if (vec == 2)
    launch_splat_vec<Td, Tc, 2>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C, st);
  else
    launch_splat_vec<Td, Tc, 1>(ctx, offs, sorted, out, heavy_list, n_heavy, n_rows, C, st);
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

// ---- S1-rows ----

constexpr int ROWS_THREADS = 64;           // a splat block's threads (2 warps)
constexpr int ROWS_STAGES = 2;             // the ring's stages: 1 in flight
constexpr int ROWS_STAGE = 32;             // rows a stage gathers at most
constexpr int ROWS_RING_BYTES = 16 * 1024; // the ring's rows at most
constexpr int ROWS_MAX_COST = 128;         // a splat block's voxels + rows at most
constexpr int ROWS_MAX_PASSES = 8;         // passes of 32 lanes x VEC channels
static_assert(ROWS_STAGE <= ROWS_THREADS, "a thread loads each entry of a stage");

// 2. a thread per point: its key, counted once per group of equal keys in
// the warp
__global__ void __launch_bounds__(256)
rows_count_kernel(const int* __restrict__ coords, const uint8_t* __restrict__ valid, int n,
                  int P, int X, int Y, int Z, int* __restrict__ keys, int* __restrict__ counts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int key = -1;
  if (p < n && valid[p]) {
    const int x = min(max(coords[3 * (int64_t)p + 0], 0), X - 1);
    const int y = min(max(coords[3 * (int64_t)p + 1], 0), Y - 1);
    const int z = min(max(coords[3 * (int64_t)p + 2], 0), Z - 1);
    key = (p / P) * (X * Y * Z) + (x * Y + y) * Z + z;
  }
  if (p < n) keys[p] = key;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counts + key, __popc(peers));
}

// 3. in place: data[0, n) becomes its exclusive scan, cursor[0, n - 1) a
// copy; a block per SCAN_TILE counts, in the order of `ticket`, each tile's
// sum published in status[tile] as (1 << 32 | sum), its inclusive prefix as
// (2 << 32 | prefix), the predecessors' read back, 32 at a time, to the
// nearest prefix
__global__ void __launch_bounds__(SCAN_THREADS)
rows_scan_kernel(int* __restrict__ data, int64_t n, int* __restrict__ cursor,
                 unsigned long long* __restrict__ status, int* __restrict__ ticket) {
  __shared__ int s_tile, s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t base = (int64_t)tile * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = base + k < n ? data[base + k] : 0;
    sum += v[k];
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) atomicExch(status + tile, (1ull << 32) | (unsigned)total);
      for (int j0 = tile - 1;; j0 -= 32) {
        const int j = j0 - lane;
        unsigned long long w = 2ull << 32;  // before tile 0: a prefix of 0
        if (j >= 0) {
          do {
            w = atomicAdd(status + j, 0ull);
          } while ((w >> 32) == 0);
        }
        const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        prefix += __reduce_add_sync(0xffffffffu, lane <= stop ? (int)(unsigned)w : 0);
        if (done) break;
      }
    }
    if (lane == 0) {
      atomicExch(status + tile, (2ull << 32) | (unsigned)(prefix + total));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  run += s_prefix;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < n) {
      data[base + k] = run;
      if (base + k < n - 1) cursor[base + k] = run;
    }
    run += v[k];
  }
}

// The splat's work is cut by cost: voxel v's rows and v itself (its store)
// cost offs[v] + v up to it, cost(n_rows) in all; block b of n_units takes
// the voxels [start[b], start[b + 1]), start[b] the first voxel whose cost
// reaches b * unit (n_rows past the total), unit = ceil(total / n_units).
__device__ __forceinline__ int64_t rows_unit(const int* offs, int64_t n_rows, int n_units) {
  return ((int64_t)offs[n_rows] + n_rows + n_units - 1) / n_units;
}

// 4. a thread per point: a slot of its voxel's span, one atomic per group of
// equal keys in the warp, the group's slots in point order; and a thread
// per voxel: the splat blocks that start after it
__global__ void __launch_bounds__(256)
rows_fill_kernel(const int* __restrict__ keys, int n, int* __restrict__ cursor,
                 int* __restrict__ unsorted, const int* __restrict__ offs, int64_t n_rows,
                 int* __restrict__ start, int n_units) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int key = i < n ? keys[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(cursor + key, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (key >= 0) unsorted[base + __popc(peers & ((1u << lane) - 1u))] = (int)i;
  if (i < n_rows) {
    const int64_t unit = rows_unit(offs, n_rows, n_units);
    const int64_t c0 = offs[i] + i, c1 = offs[i + 1] + i + 1;
    for (int64_t b = c0 / unit + 1; b <= c1 / unit; ++b) start[b] = (int)(i + 1);
  }
}

// 5. a thread per valid point: its rank among its span's points
__global__ void __launch_bounds__(256)
rows_rank_kernel(const int* __restrict__ keys, int n, const int* __restrict__ offs,
                 const int* __restrict__ unsorted, int* __restrict__ sorted) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int key = keys[p];
  if (key < 0) return;
  const int beg = offs[key], end = offs[key + 1];
  int r = 0;
  for (int j = beg; j < end; ++j) r += __ldg(unsorted + j) < p;
  sorted[beg + r] = p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed but those of its last ROWS_STAGES - 1
// committed groups
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(ROWS_STAGES - 1) : "memory");
}

// 6. a block per unit of the splat's work (rows_unit): its voxels' rows, one
// run of the sorted entries, gathered in stages of nb rows (`rs` bytes apart
// in shared memory; by 16-byte cp.async when `vec16`) into a ring of
// ROWS_STAGES, added in entry order by each voxel's warp, each voxel's row
// stored once
template <typename T, int VEC, int MAXP>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_splat_kernel(const T* __restrict__ feats, const int* __restrict__ offs,
                  const int* __restrict__ sorted, const int* __restrict__ start,
                  T* __restrict__ out, int64_t n_rows, int C, int nb, int rs, int vec16) {
  using RawT = typename Raw<VEC * sizeof(T)>::T;
  constexpr int W = ROWS_THREADS / 32;
  constexpr int R = ROWS_STAGES;
  extern __shared__ __align__(128) unsigned char rows_smem[];
  unsigned char* ring = rows_smem;                                // [R][nb][rs]
  int* ent = reinterpret_cast<int*>(ring + R * (size_t)nb * rs);  // [R][nb]
  int* off = ent + R * nb;                                        // [ROWS_MAX_COST + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t unit = rows_unit(offs, n_rows, gridDim.x);
  const int64_t total = (int64_t)offs[n_rows] + n_rows;
  const int64_t b = blockIdx.x;
  const int64_t v0 = b * unit > total ? n_rows : start[b];
  const int64_t v1 = (b + 1) * unit > total ? n_rows : start[b + 1];
  const int tv = (int)(v1 - v0);
  if (tv <= 0) return;
  const int rb = C * (int)sizeof(T);
  for (int i = tid; i <= tv; i += ROWS_THREADS) off[i] = offs[v0 + i];
  __syncthreads();
  const int E0 = off[0], E1 = off[tv];
  const int n_st = max(1, (E1 - E0 + nb - 1) / nb);
  auto stage_n = [&](int k) { return max(0, min(nb, E1 - E0 - k * nb)); };
  auto entry = [&](int k) { return tid < stage_n(k) ? sorted[E0 + k * nb + tid] : 0; };
  // stage k's rows (its entries in ent[k % R]) into ring[k % R]
  auto issue = [&](int k) {
    const int n = stage_n(k);
    const int* e = ent + (k % R) * nb;
    unsigned char* dst = ring + (size_t)(k % R) * nb * rs;
    if (vec16) {
      const int cpr = rb >> 4;  // 16-byte chunks a row
      for (int i = tid; i < n * cpr; i += ROWS_THREADS) {
        const int j = i / cpr, q = i - j * cpr;
        cp_async16(dst + (size_t)j * rs + q * 16,
                   reinterpret_cast<const unsigned char*>(feats) + (int64_t)e[j] * rb + q * 16);
      }
    } else {
      for (int i = tid; i < n * C; i += ROWS_THREADS) {
        const int j = i / C, c = i - j * C;
        reinterpret_cast<T*>(dst + (size_t)j * rs)[c] = feats[(int64_t)e[j] * C + c];
      }
    }
  };
  // the first R - 1 stages in flight
  for (int k = 0; k < R - 1; ++k) {
    const int e = entry(k);
    if (tid < nb) ent[k * nb + tid] = e;
  }
  int e_next = entry(R - 1);
  __syncthreads();
  for (int k = 0; k < R - 1; ++k) {
    if (k < n_st) issue(k);
    cp_async_commit();
  }
  const int passes = (C + 32 * VEC - 1) / (32 * VEC);
  constexpr int ROWS_UNROLL = MAXP >= 8 ? 2 : MAXP >= 4 ? 4 : 8;  // rows read, then added
  float acc[MAXP][VEC];
#pragma unroll
  for (int q = 0; q < MAXP; ++q)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
  // warp w owns the groups of 32 voxels w, w + W, ...; lane l holds voxel
  // g * 32 + l's span [lo, hi); vi is the group's first voxel not stored yet
  int g = warp, vi = 0, lo = E1, hi = E1;
  auto load_group = [&]() {
    const int v = g * 32 + lane;
    lo = v <= tv ? off[v] : E1;
    hi = v + 1 <= tv ? off[v + 1] : E1;
  };
  load_group();
  for (int k = 0; k < n_st; ++k) {
    const int kn = k + R - 1;  // the stage to put in flight
    if (tid < nb) ent[(kn % R) * nb + tid] = e_next;
    __syncthreads();  // stage k - 1's rows are added: its ring slot is free
    if (kn < n_st) issue(kn);
    cp_async_commit();
    e_next = entry(kn + 1);
    cp_async_wait_stage();
    __syncthreads();  // stage k's rows are in
    const int S = E0 + k * nb, end = S + stage_n(k);
    const unsigned char* rows = ring + (size_t)(k % R) * nb * rs;
    // this warp's voxels that take rows from this stage or end in it, in order
    while (g * 32 < tv) {
      if (vi == 32 || g * 32 + vi >= tv) {
        g += W;
        vi = 0;
        load_group();
        continue;
      }
      const int ou = __shfl_sync(0xffffffffu, lo, vi), ou1 = __shfl_sync(0xffffffffu, hi, vi);
      if (ou == ou1 ? ou > end : ou >= end) break;  // its rows come in a later stage
      for (int t0 = max(ou, S); t0 < min(ou1, end); t0 += ROWS_UNROLL) {
        const int tn = min(ou1, end) - t0;
        RawT r[ROWS_UNROLL][MAXP];
#pragma unroll
        for (int i = 0; i < ROWS_UNROLL; ++i)
#pragma unroll
          for (int q = 0; q < MAXP; ++q) {
            const int c = (q * 32 + lane) * VEC;
            r[i][q] = i < tn && q < passes && c < C
                          ? *reinterpret_cast<const RawT*>(
                                reinterpret_cast<const T*>(rows + (size_t)(t0 - S + i) * rs) + c)
                          : RawT{};
          }
#pragma unroll
        for (int i = 0; i < ROWS_UNROLL; ++i) {
          if (i >= tn) break;
#pragma unroll
          for (int q = 0; q < MAXP; ++q) {
            float f[VEC];
            chunk_floats<T, VEC>(f, r[i][q]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] = __fadd_rn(acc[q][e], f[e]);
          }
        }
      }
      if (ou1 > end) break;  // its rows go on in the next stage
#pragma unroll
      for (int q = 0; q < MAXP; ++q) {
        const int c = (q * 32 + lane) * VEC;
        if (q < passes && c < C) store_chunk<T, VEC>(out + (v0 + g * 32 + vi) * C + c, acc[q]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
      }
      ++vi;
    }
  }
}

static inline size_t rows_splat_smem(int nb, int rs) {
  return ROWS_STAGES * ((size_t)nb * rs + (size_t)nb * sizeof(int)) +
         (ROWS_MAX_COST + 1) * sizeof(int);
}

template <typename T, int VEC, int MAXP>
static cudaError_t launch_rows_splat(const void* feats, const int* offs, const int* sorted,
                                     const int* start, int n_units, void* out, int64_t n_rows,
                                     int C, int nb, int rs, int vec16, cudaStream_t st) {
  auto kernel = rows_splat_kernel<T, VEC, MAXP>;
  const size_t smem = rows_splat_smem(nb, rs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)n_units, ROWS_THREADS, smem, st>>>((const T*)feats, offs, sorted, start,
                                                        (T*)out, n_rows, C, nb, rs, vec16);
  return cudaGetLastError();
}

template <typename T, int VEC>
static cudaError_t rows_splat_vec(int passes, const void* feats, const int* offs,
                                  const int* sorted, const int* start, int n_units, void* out,
                                  int64_t n_rows, int C, int nb, int rs, int vec16,
                                  cudaStream_t st) {
  if (passes <= 1)
    return launch_rows_splat<T, VEC, 1>(feats, offs, sorted, start, n_units, out, n_rows, C,
                                        nb, rs, vec16, st);
  if (passes <= 2)
    return launch_rows_splat<T, VEC, 2>(feats, offs, sorted, start, n_units, out, n_rows, C,
                                        nb, rs, vec16, st);
  if (passes <= 4)
    return launch_rows_splat<T, VEC, 4>(feats, offs, sorted, start, n_units, out, n_rows, C,
                                        nb, rs, vec16, st);
  return launch_rows_splat<T, VEC, 8>(feats, offs, sorted, start, n_units, out, n_rows, C, nb,
                                      rs, vec16, st);
}

template <typename T>
static cudaError_t rows_splat(int vec, int passes, const void* feats, const int* offs,
                              const int* sorted, const int* start, int n_units, void* out,
                              int64_t n_rows, int C, int nb, int rs, int vec16,
                              cudaStream_t st) {
  if (vec == 4)
    return rows_splat_vec<T, 4>(passes, feats, offs, sorted, start, n_units, out, n_rows, C,
                                nb, rs, vec16, st);
  if (vec == 2)
    return rows_splat_vec<T, 2>(passes, feats, offs, sorted, start, n_units, out, n_rows, C,
                                nb, rs, vec16, st);
  return rows_splat_vec<T, 1>(passes, feats, offs, sorted, start, n_units, out, n_rows, C, nb,
                              rs, vec16, st);
}

// The S1-rows workspace's parts: from its start, the part the memset zeroes
// (the scan's tile words, its ticket, the counts that become the offsets,
// the splat blocks' first voxels), then the fill's cursor, the keys, the
// filled and the sorted spans.
struct RowsSpace {
  unsigned long long* status;  // [scan tiles]
  int* ticket;                 // [2]
  int* offs;                   // [n_rows + 1]
  int* start;                  // [n_units + 1]
  int64_t zeroed_ints;
  int* cursor;                 // [n_rows]
  int* keys;                   // [n_pts]
  int* unsorted;               // [n_pts]
  int* sorted;                 // [n_pts]
};

// The splat's blocks: enough that no block's share of the cost exceeds
// ROWS_MAX_COST (every row of feats counted, valid or not)
static inline int64_t rows_units(int64_t n_rows, int64_t n_pts) {
  return (n_rows + n_pts + ROWS_MAX_COST - 1) / ROWS_MAX_COST;
}

static inline RowsSpace rows_space(void* workspace, int64_t n_rows, int64_t n_pts) {
  RowsSpace s;
  const int64_t tiles = scan_tile_count(n_rows + 1);
  s.status = (unsigned long long*)workspace;
  s.ticket = (int*)(s.status + tiles);
  s.offs = s.ticket + 2;
  s.start = s.offs + n_rows + 1;
  s.zeroed_ints = 2 * tiles + 2 + n_rows + 1 + rows_units(n_rows, n_pts) + 1;
  s.cursor = s.start + rows_units(n_rows, n_pts) + 1;
  s.keys = s.cursor + n_rows;
  s.unsorted = s.keys + n_pts;
  s.sorted = s.unsorted + n_pts;
  return s;
}

// Int32s of voxel_splat_rows' workspace for n_rows voxel rows and n_pts rows
// of feats.
extern "C" long long voxel_splat_rows_workspace(long long n_rows, long long n_pts) {
  return 2 * scan_tile_count(n_rows + 1) + 2 + 2 * n_rows + 1 + rows_units(n_rows, n_pts) +
         1 + 3 * n_pts;
}

// S1-rows, plain C entry point, loaded with ctypes.  feats [B * P, C] float32
// (dtype 0) or bfloat16 (dtype 1); coords int32 [B * P, 3]; valid bool
// [B * P]; out [B * X * Y * Z, C] in feats' dtype, written in full;
// workspace voxel_splat_rows_workspace(B * X * Y * Z, B * P) int32s, 8-byte
// aligned.  The rows and voxels below 2^31; C at most ROWS_MAX_PASSES
// passes of 32 lanes (a row of at most ROWS_RING_BYTES / ROWS_STAGES bytes).
// Launches on `stream` and returns the first CUDA error, or
// cudaErrorInvalidValue for anything else.
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
  // the splat's lane chunks as wide as the row and out's alignment allow
  int vec = 4;
  while (vec > 1 && (C % vec != 0 || (uintptr_t)out % (vec * size) != 0)) vec /= 2;
  const int passes = (C + 32 * vec - 1) / (32 * vec);
  const int rb = C * size, rs = (rb + 15) / 16 * 16;
  const int nb = min(ROWS_STAGE, ROWS_RING_BYTES / (ROWS_STAGES * rs));
  if (passes > ROWS_MAX_PASSES || nb < 1) return (int)cudaErrorInvalidValue;
  const int vec16 = rb % 16 == 0 && (uintptr_t)feats % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const RowsSpace s = rows_space(workspace, n_rows, n_pts);
  const int n_units = (int)rows_units(n_rows, n_pts);
  cudaError_t err = cudaMemsetAsync(workspace, 0, s.zeroed_ints * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  if (n_pts > 0)
    rows_count_kernel<<<(unsigned)((n_pts + threads - 1) / threads), threads, 0, st>>>(
        (const int*)coords, (const uint8_t*)valid, (int)n_pts, P, X, Y, Z, s.keys, s.offs);
  rows_scan_kernel<<<(unsigned)scan_tile_count(n_rows + 1), SCAN_THREADS, 0, st>>>(
      s.offs, n_rows + 1, s.cursor, s.status, s.ticket);
  const int64_t fill_threads = n_pts > n_rows ? n_pts : n_rows;
  rows_fill_kernel<<<(unsigned)((fill_threads + threads - 1) / threads), threads, 0, st>>>(
      s.keys, (int)n_pts, s.cursor, s.unsorted, s.offs, n_rows, s.start, n_units);
  if (n_pts > 0)
    rows_rank_kernel<<<(unsigned)((n_pts + threads - 1) / threads), threads, 0, st>>>(
        s.keys, (int)n_pts, s.offs, s.unsorted, s.sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = dtype ? rows_splat<__nv_bfloat16>(vec, passes, feats, s.offs, s.sorted, s.start, n_units,
                                          out, n_rows, C, nb, rs, vec16, st)
              : rows_splat<float>(vec, passes, feats, s.offs, s.sorted, s.start, n_units, out,
                                  n_rows, C, nb, rs, vec16, st);
  return (int)err;
}

// ---- S1-bwd and S1-rows-bwd ----
//
// S1-bwd (voxel_splat_bwd) is S1's backward: with g the volume's gradient
// [B * X*Y*Z, C] (in depth's dtype) and row(p) the voxel of frustum point p
// (as SplatKeys),
//
//   d_depth[p]    = valid[p] ? sum over c of g[row(p), c] * ctx[pixel(p), c] : 0
//   d_ctx[q, c]   = sum over the pixel's depth bins d of
//                   (valid[p] ? depth[p] * g[row(p), c] : 0),  p = (q, d)
//
// in depth's and ctx's dtypes, each sum kept in float32 and rounded once.
// The JAX package takes it by autodiff of the XLA scatter-add
// (occformer_tpu/ops/scatter.py:55, a gather of the cotangent).  Its plain
// version (ops/scatter.py:voxel_scatter_backward_plain) gathers a float32
// row of g for every point into a [B, N, D, fH, fW, C] tensor and forms two
// more of that size; at the R101 frustum (3.76 M points, C = 128) each is
// 1.93 GB.
//
// Bound: valid read in full; the row of g of each filled voxel, the valid
// points' depth and coords and ctx's row of each pixel holding a valid point
// read once (an invalid point needs none of them); d_depth and d_ctx written
// once; a gather, bound by bytes.
// Its cost is the latency of the scattered row reads, as the forward's.
//
// Design: a block of BWD_WARPS warps per pixel, its warps on contiguous
// chunks of the pixel's depth bins, a lane on VEC channels (as S1's splat:
// 16-byte-or-less vectors as wide as C and the pointers allow), more passes
// of 32 * VEC channels where C is wider.  Lane j computes bin d0 + j's voxel
// row (int32, from coords and valid) and depth for 32 bins at once; the warp
// broadcasts them by shuffles and each lane issues the g loads of
// BWD_INFLIGHT bins before their FMAs; an invalid bin issues no load.
// d_depth: each lane's channels, then a fixed xor-shuffle tree over the
// lanes, the passes added in order in shared memory, one store a bin.
// d_ctx: each lane's sums in ascending bin within its warp, the warps'
// partials added in warp order through shared memory, one store a row.  No
// atomics, no library call: two calls give the same bits.
//
// The gradient's layout: the occupancy encoder reads the volume as
// volume.permute(0, 4, 1, 2, 3), so at batch 1 its gradient reaches the op
// as a transposed view ([C, rows] in memory).  PyTorch's strided copy of it
// into rows (the plain version's F.pad) took 0.35 device ms of a flagship
// step, five times S1-bwd's gathers (H100 80GB HBM3 at 700 W); both entry
// points instead take such a gradient with gout_t = 1 and copy it into rows
// (gbuf) with s1_bwd_transpose_kernel / rows_bwd_transpose_kernel, 32 x 32
// tiles through shared memory (about 0.09 ms), before their gathers.
//
// S1-rows-bwd (voxel_splat_rows_bwd) is S1-rows' backward, a copy:
//
//   d_feats[p, :] = valid[p] ? g[row(p), :] : 0
//
// in feats' dtype (g has it), equal bit for bit to the plain gather
// (ops/scatter.py:voxel_scatter_rows_backward_plain, which pads a copy of g
// with a zero row and index_selects every point).  A thread per (point,
// vector of VB bytes), VB the widest of 16, 8, 4 and 2 that divides the row
// and the addresses of g and d_feats; an invalid point reads no coords and
// no row and stores zeros.  Bound: valid read in full, the valid points'
// coords and the row of g of each filled voxel read once (the points of a
// voxel share it), d_feats written once.
//
// Measured by chip_smoke.py in one run (H100 80GB HBM3 at 700 W; device ms
// on rows of g and on the transposed gradient the main path hands over, the
// transpose included; the plain versions and the library call by CUDA
// events; PERF.md section 6 keeps each run's figures).  S1-bwd at the
// nuScenes rig (278,782 of 473,088 points valid, C = 128, bf16): 0.070 on
// rows, 0.164 transposed, against 1.51 ms for the plain backward on that
// gradient and 0.95 ms for autograd through one index_add_; bound 0.0105.
// At SemanticKITTI's 215,040 points 0.030 / 0.125 (bound 0.0056), at the
// R101-DCN's 3,763,200 0.452 / 0.539 (bound 0.0321).  S1-rows-bwd at the
// use_voxel_net flagship (473,088 rows of 128, bf16): 0.064 on rows (bound
// 0.0456), 0.153 transposed, against 0.92 ms for the plain gather.

// out[r, c] = in[c, r]: in [C, R], out [R, C], elements of `Bytes` bytes;
// a block of 32 x 8 threads per 32 x 32 tile
template <int Bytes>
__device__ __forceinline__ void transpose_tile(const void* __restrict__ in_,
                                               void* __restrict__ out_, int64_t R, int C) {
  using T = typename Raw<Bytes>::T;
  const T* in = static_cast<const T*>(in_);
  T* out = static_cast<T*>(out_);
  __shared__ T tile[32][33];
  const int64_t r0 = (int64_t)blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int c = c0 + j;
    const int64_t r = r0 + threadIdx.x;
    if (c < C && r < R) tile[j][threadIdx.x] = in[(int64_t)c * R + r];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int64_t r = r0 + j;
    const int c = c0 + threadIdx.x;
    if (r < R && c < C) out[r * C + c] = tile[threadIdx.x][j];
  }
}

// the two backwards' transposes, apart by name in a profile
template <int Bytes>
__global__ void __launch_bounds__(256)
s1_bwd_transpose_kernel(const void* __restrict__ in, void* __restrict__ out, int64_t R, int C) {
  transpose_tile<Bytes>(in, out, R, C);
}

template <int Bytes>
__global__ void __launch_bounds__(256)
rows_bwd_transpose_kernel(const void* __restrict__ in, void* __restrict__ out, int64_t R, int C) {
  transpose_tile<Bytes>(in, out, R, C);
}

// *gout as rows [R, C]: itself, or (gout_t) its [C, R] transpose copied
// into gbuf, which *gout then points to (S1-rows-bwd's when `rows`)
static cudaError_t grad_rows(const void** gout, int gout_t, void* gbuf, int64_t R, int C,
                             int bytes, bool rows, cudaStream_t st) {
  if (!gout_t || C == 0) return cudaSuccess;
  const dim3 grid((unsigned)((R + 31) / 32), (unsigned)((C + 31) / 32)), block(32, 8);
  if (bytes == 2 && rows)
    rows_bwd_transpose_kernel<2><<<grid, block, 0, st>>>(*gout, gbuf, R, C);
  else if (bytes == 2)
    s1_bwd_transpose_kernel<2><<<grid, block, 0, st>>>(*gout, gbuf, R, C);
  else if (rows)
    rows_bwd_transpose_kernel<4><<<grid, block, 0, st>>>(*gout, gbuf, R, C);
  else
    s1_bwd_transpose_kernel<4><<<grid, block, 0, st>>>(*gout, gbuf, R, C);
  *gout = gbuf;
  return cudaGetLastError();
}

constexpr int BWD_WARPS = 4;      // a pixel's block: warps over its depth bins
constexpr int BWD_INFLIGHT = 16;  // bins whose g loads a lane issues before their FMAs
constexpr int BWD_MAX_D = 8192;   // depth bins at most (their d_depth in shared memory)

template <typename Td, typename Tc, int VEC>
__global__ void __launch_bounds__(BWD_WARPS * 32)
voxel_splat_bwd_kernel(const Td* __restrict__ depth, const Tc* __restrict__ ctx,
                       const int* __restrict__ coords, const uint8_t* __restrict__ valid,
                       const Td* __restrict__ gout, Td* __restrict__ d_depth,
                       Tc* __restrict__ d_ctx, int N, int D, int HW, int X, int Y, int Z, int C) {
  using RawG = typename Raw<VEC * sizeof(Td)>::T;
  using RawC = typename Raw<VEC * sizeof(Tc)>::T;
  __shared__ float part[BWD_WARPS - 1][VEC][32];  // warps 1.. d_ctx partials
  extern __shared__ float dd[];                   // [D]: each bin's d_depth so far
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t q = blockIdx.x;  // the pixel (b * N + n) * HW + hw
  const int64_t bn = q / HW;
  const int64_t p0 = bn * D * HW + (q - bn * HW);  // its bin 0; bin d is p0 + d * HW
  const int64_t base = (bn / N) * X * Y * Z;      // its batch item's first voxel row
  const int per = (D + BWD_WARPS - 1) / BWD_WARPS;
  const int d_lo = min(D, warp * per), d_hi = min(D, d_lo + per);
  const int passes = max(1, (C + 32 * VEC - 1) / (32 * VEC));  // C = 0: d_depth's zeros
  for (int pass = 0; pass < passes; ++pass) {
    const int c = (pass * 32 + lane) * VEC;
    const bool on = c < C;
    float cv[VEC], acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) cv[e] = acc[e] = 0.f;
    if (on) chunk_floats<Tc, VEC>(cv, __ldg(reinterpret_cast<const RawC*>(ctx + q * C + c)));
    for (int d0 = d_lo; d0 < d_hi; d0 += 32) {
      const int nb = min(32, d_hi - d0);
      int row = -1;
      float dep = 0.f;
      if (lane < nb) {
        const int64_t p = p0 + (int64_t)(d0 + lane) * HW;
        if (valid[p]) {
          const int x = min(max(coords[3 * p + 0], 0), X - 1);
          const int y = min(max(coords[3 * p + 1], 0), Y - 1);
          const int z = min(max(coords[3 * p + 2], 0), Z - 1);
          row = (x * Y + y) * Z + z;
          dep = to_f(depth[p]);
        }
      }
      float mine = 0.f;  // lane j: bin d0 + j's d_depth over this pass's channels
      for (int j0 = 0; j0 < nb; j0 += BWD_INFLIGHT) {
        RawG v[BWD_INFLIGHT];
        int r[BWD_INFLIGHT];
        float dj[BWD_INFLIGHT];
#pragma unroll
        for (int k = 0; k < BWD_INFLIGHT; ++k) {
          const int j = j0 + k;
          r[k] = __shfl_sync(0xffffffffu, row, j & 31);
          dj[k] = __shfl_sync(0xffffffffu, dep, j & 31);
          if (j >= nb) r[k] = -1;
          v[k] = on && r[k] >= 0
                     ? __ldg(reinterpret_cast<const RawG*>(gout + (base + r[k]) * C + c))
                     : RawG{};
        }
#pragma unroll
        for (int k = 0; k < BWD_INFLIGHT; ++k) {
          if (r[k] < 0) continue;  // the same for every lane
          float g[VEC];
          chunk_floats<Td, VEC>(g, v[k]);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s = fmaf(g[e], cv[e], s);
            acc[e] = fmaf(dj[k], g[e], acc[e]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == j0 + k) mine = s;
        }
      }
      if (lane < nb) dd[d0 + lane] = pass == 0 ? mine : dd[d0 + lane] + mine;
    }
    // d_ctx: the warps' sums in warp order
    if (warp > 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[warp - 1][e][lane] = acc[e];
    }
    __syncthreads();
    if (warp == 0 && on) {
      for (int w = 0; w < BWD_WARPS - 1; ++w)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += part[w][e][lane];
      store_chunk<Tc, VEC>(d_ctx + q * C + c, acc);
    }
    __syncthreads();
  }
  // d_depth: each warp's own bins (its lanes wrote them above)
  for (int d = d_lo + lane; d < d_hi; d += 32) {
    Td o;
    from_f(o, dd[d]);
    d_depth[p0 + (int64_t)d * HW] = o;
  }
}

template <typename Td, typename Tc>
static cudaError_t launch_splat_bwd(const void* depth, const void* ctx, const void* coords,
                                    const void* valid, const void* gout, void* d_depth,
                                    void* d_ctx, int64_t n_pix, int N, int D, int HW, int X,
                                    int Y, int Z, int C, int vec, cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(float);
#define S1_BWD_ARGS                                                                          \
  (const Td*)depth, (const Tc*)ctx, (const int*)coords, (const uint8_t*)valid,               \
      (const Td*)gout, (Td*)d_depth, (Tc*)d_ctx, N, D, HW, X, Y, Z, C
  if (vec == 4)
    voxel_splat_bwd_kernel<Td, Tc, 4><<<(unsigned)n_pix, BWD_WARPS * 32, smem, st>>>(S1_BWD_ARGS);
  else if (vec == 2)
    voxel_splat_bwd_kernel<Td, Tc, 2><<<(unsigned)n_pix, BWD_WARPS * 32, smem, st>>>(S1_BWD_ARGS);
  else
    voxel_splat_bwd_kernel<Td, Tc, 1><<<(unsigned)n_pix, BWD_WARPS * 32, smem, st>>>(S1_BWD_ARGS);
#undef S1_BWD_ARGS
  return cudaGetLastError();
}

// S1-bwd, plain C entry point, loaded with ctypes.  depth [B, N, D, fH, fW]
// and ctx [B, N, fH, fW, C], each float32 (dtype 0) or bfloat16 (dtype 1);
// coords int32 [B, N, D, fH, fW, 3]; valid bool [B, N, D, fH, fW]; gout
// [B * X * Y * Z, C] in depth's dtype, or with gout_t its transpose [C, B *
// X * Y * Z] and gbuf room for the rows; d_depth like depth and d_ctx like
// ctx, each written in full.  The points and rows below 2^31, D at most
// BWD_MAX_D.  Launches on `stream` and returns the first CUDA error, or
// cudaErrorInvalidValue for anything else.
extern "C" int voxel_splat_bwd(const void* depth, const void* ctx, const void* coords,
                               const void* valid, const void* gout, int gout_t, void* gbuf,
                               void* d_depth, void* d_ctx, int B, int N, int D, int HW, int X,
                               int Y, int Z, int C, int depth_dtype, int ctx_dtype,
                               void* stream) {
  const int64_t n_pix = (int64_t)B * N * HW;
  const int64_t n_pts = n_pix * D;
  const int64_t n_rows = (int64_t)B * X * Y * Z;
  if (depth_dtype < 0 || depth_dtype > 1 || ctx_dtype < 0 || ctx_dtype > 1 || D > BWD_MAX_D ||
      n_pts >= ((int64_t)1 << 31) || n_rows >= ((int64_t)1 << 31) || X <= 0 || Y <= 0 ||
      Z <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_pts == 0) return 0;
  const int c_size = ctx_dtype ? 2 : 4, d_size = depth_dtype ? 2 : 4;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = grad_rows(&gout, gout_t, gbuf, n_rows, C, d_size, false, st);
  if (err != cudaSuccess) return (int)err;
  // loads and stores as wide as the row and the alignments of ctx, gout and
  // d_ctx allow
  int vec = 4;
  while (vec > 1 && (C % vec != 0 || (uintptr_t)ctx % (vec * c_size) != 0 ||
                     (uintptr_t)d_ctx % (vec * c_size) != 0 ||
                     (uintptr_t)gout % (vec * d_size) != 0))
    vec /= 2;
  const int code = depth_dtype * 2 + ctx_dtype;
  if (code == 0)
    err = launch_splat_bwd<float, float>(depth, ctx, coords, valid, gout, d_depth, d_ctx, n_pix,
                                         N, D, HW, X, Y, Z, C, vec, st);
  else if (code == 1)
    err = launch_splat_bwd<float, __nv_bfloat16>(depth, ctx, coords, valid, gout, d_depth, d_ctx,
                                                 n_pix, N, D, HW, X, Y, Z, C, vec, st);
  else if (code == 2)
    err = launch_splat_bwd<__nv_bfloat16, float>(depth, ctx, coords, valid, gout, d_depth, d_ctx,
                                                 n_pix, N, D, HW, X, Y, Z, C, vec, st);
  else
    err = launch_splat_bwd<__nv_bfloat16, __nv_bfloat16>(depth, ctx, coords, valid, gout,
                                                         d_depth, d_ctx, n_pix, N, D, HW, X, Y,
                                                         Z, C, vec, st);
  return (int)err;
}

// a thread per (point, VB-byte vector of its row)
template <int VB>
__global__ void __launch_bounds__(256)
rows_bwd_kernel(const unsigned char* __restrict__ gout, const int* __restrict__ coords,
                const uint8_t* __restrict__ valid, unsigned char* __restrict__ d_feats,
                int64_t n_vec, int cpr, int P, int X, int Y, int Z) {
  using R = typename Raw<VB>::T;
  const int64_t rb = (int64_t)cpr * VB;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int p = (int)(i / cpr);
    const int k = (int)(i - (int64_t)p * cpr);
    R v{};
    if (valid[p]) {
      const int x = min(max(coords[3 * (int64_t)p + 0], 0), X - 1);
      const int y = min(max(coords[3 * (int64_t)p + 1], 0), Y - 1);
      const int z = min(max(coords[3 * (int64_t)p + 2], 0), Z - 1);
      const int64_t row = (int64_t)(p / P) * X * Y * Z + (x * Y + y) * Z + z;
      v = __ldg(reinterpret_cast<const R*>(gout + row * rb) + k);
    }
    reinterpret_cast<R*>(d_feats + (int64_t)p * rb)[k] = v;
  }
}

// S1-rows-bwd, plain C entry point, loaded with ctypes.  gout [B * X * Y *
// Z, C] float32 (dtype 0) or bfloat16 (dtype 1), or with gout_t its
// transpose and gbuf room for the rows; coords int32 [B * P, 3]; valid bool
// [B * P]; d_feats [B * P, C] in gout's dtype, written in full.  The rows
// and voxels below 2^31.  Launches on `stream` and returns the first CUDA
// error, or cudaErrorInvalidValue for anything else.
extern "C" int voxel_splat_rows_bwd(const void* gout, int gout_t, void* gbuf,
                                    const void* coords, const void* valid, void* d_feats, int B,
                                    int P, int X, int Y, int Z, int C, int dtype,
                                    void* stream) {
  const int64_t n_pts = (int64_t)B * P;
  const int64_t n_rows = (int64_t)B * X * Y * Z;
  if (dtype < 0 || dtype > 1 || n_pts >= ((int64_t)1 << 31) ||
      n_rows >= ((int64_t)1 << 31) || X <= 0 || Y <= 0 || Z <= 0)
    return (int)cudaErrorInvalidValue;
  const int rb = C * (dtype ? 2 : 4);
  if (n_pts == 0 || rb == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = grad_rows(&gout, gout_t, gbuf, n_rows, C, dtype ? 2 : 4, true, st);
  if (err != cudaSuccess) return (int)err;
  int vb = 16;
  while (vb > 2 && (rb % vb != 0 || (uintptr_t)gout % vb != 0 || (uintptr_t)d_feats % vb != 0))
    vb /= 2;
  const int cpr = rb / vb;
  const int64_t n_vec = n_pts * cpr;
  const int threads = 256;
#define ROWS_BWD_ARGS                                                                     \
  (const unsigned char*)gout, (const int*)coords, (const uint8_t*)valid,                  \
      (unsigned char*)d_feats, n_vec, cpr, P, X, Y, Z
  if (vb == 16)
    rows_bwd_kernel<16><<<grid_blocks(n_vec, threads), threads, 0, st>>>(ROWS_BWD_ARGS);
  else if (vb == 8)
    rows_bwd_kernel<8><<<grid_blocks(n_vec, threads), threads, 0, st>>>(ROWS_BWD_ARGS);
  else if (vb == 4)
    rows_bwd_kernel<4><<<grid_blocks(n_vec, threads), threads, 0, st>>>(ROWS_BWD_ARGS);
  else
    rows_bwd_kernel<2><<<grid_blocks(n_vec, threads), threads, 0, st>>>(ROWS_BWD_ARGS);
#undef ROWS_BWD_ARGS
  return (int)cudaGetLastError();
}
