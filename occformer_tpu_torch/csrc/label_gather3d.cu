// GT corner-label gather with the per-slot compare fused (K3).
//
// Replaces the TPU kernel occformer_tpu/ops/loss_gather.py:_build_op.call
// (:127, body _label_kernel :49, public gather_corner_labels :258), which
// gathers the 8 trilinear corner labels of row-sorted points from a
// [N, X*Y, Z] label slab into [N, S, 8] and leaves the weights and the
// per-slot compare to XLA (labels_to_masks, mask2former_loss.py:458-479).
// Here one kernel computes what the loss reads, the soft per-slot GT mask
//
//   out[n, g, s] = sum over the 8 corners k of w_k * (label_k == slot_id[g])
//
// at points in [0, 1] (pts[..., i] indexes spatial axis i: x, y, z), reading
// label grid n % B.  The arithmetic is the plain version's
// (ops/loss_gather.py:sample_id_masks_plain, JAX _corner_weights and
// _sample_id_masks):
//   align_corners=1: c = v * (n - 1);  align_corners=0: c = v * n - 0.5
//   border: c is clipped to [0, n - 1];  zeros: a corner outside the grid
//   has weight 0.  Corner indices are clamped to the grid.
// Products are rounded one at a time (__fmul_rn, no fused multiply-add) and
// the 8 terms are added in the plain version's order, so the result is the
// plain version's bit for bit.  Unlike the Pallas kernel, padding_mode is
// honoured (that kernel always clamps to the border), and the points are
// used in [0, 1] directly, with no round trip through [-1, 1] that can move
// floor() by one on grids whose sides are not powers of two.
//
// Two entry points:
//   shared:   points [N, S, 3], slot ids [B, G] -> out [N, G, S]
//   per-slot: points [N, G, P, 3], point (n, g, p) compared with slot g's
//             id only -> out [N, G, P]
//
// Design: a thread takes PPT consecutive points of a row.  It computes each
// point's 8 weights and clamped indices once, issues the 8 * PPT label loads
// (int32, from the grid, which stays in L2) before any compare, and loops
// over the slots, storing its PPT outputs of a slot as one vector store
// along s where the row's length keeps the vectors aligned.  The output is
// slot-major, so a warp's store of one slot covers 32 * PPT neighbouring
// points.  A corner outside the grid (zeros padding) has weight 0 and reads
// the clamped index's label: adding its 0 leaves the sum unchanged, so the
// bits are the plain version's.  What holds it back, measured at the
// flagship's candidates (tools/time_backwards.py --only K3, H100 80GB HBM3,
// 700 W; PERF.md, section 6): with one slot (the label gather and one store a
// point) it takes 0.056-0.060 device ms, a plain write of its 102 MB output
// 0.031-0.032, the whole 0.068-0.075: the gather's scattered label loads
// (1.5 M points x 8 corners, 32-byte sectors from L2) set the pace and the
// stores overlap them only in part.  Points a thread and loads, device ms,
// candidates / matching / random fill, in turns in one call: 1 point 0.068 /
// 0.026 / 0.083-0.086, 2 points 0.087 / 0.030 / 0.089, 4 points 0.083 /
// 0.031 / 0.085; with a z-neighbour pair read as one 16-byte load where it
// shares an aligned quad of the grid, 1 point 0.071-0.072 / 0.028 / 0.076,
// 2 points 0.081-0.082 / 0.029 / 0.074, 4 points 0.088-0.099 / 0.038 /
// 0.076 (the parent, one thread a point: 0.073 / 0.028 / 0.080-0.083).  So
// the shared kernel takes one point a thread with plain loads, the per-slot
// kernel (the random fill: a gather per output) two points a thread with
// the paired loads and 8-byte stores.  The first design ran a thread per
// point with int64 indices and a load per corner: 0.107 ms by events at the
// candidates (PERF.md, section 6).

// Bound on an H100 SXM at the flagship's candidate readout (N = 10 layers x
// samples, S = 150528, G = 17, int32 grid 256 x 256 x 32): points 18.1 MB
// and the grid 8.4 MB read, the output 102.4 MB written, about 129 MB, about
// 38 us at 3.35 TB/s; the compares (16 operations per point and slot) take
// a tenth of that.  The corner reads of random points mostly miss L1, but
// the 8.4 MB grid stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

// Point p's 8 corner weights (0 outside the grid under zeros padding) and
// flat indices (clamped into the grid), in (dx, dy, dz) order.
__device__ __forceinline__ void point_corners(const float* p, int Xg, int Yg, int Zg, int align,
                                              int border, float (&w)[8], int (&idx)[8]) {
  const int size[3] = {Xg, Yg, Zg};
  float lo[3], frac[3];
  for (int i = 0; i < 3; ++i) {
    const float n = (float)size[i];
    float c = align ? __fmul_rn(p[i], n - 1.f) : __fsub_rn(__fmul_rn(p[i], n), 0.5f);
    if (border) c = fminf(fmaxf(c, 0.f), n - 1.f);
    lo[i] = floorf(c);
    frac[i] = __fsub_rn(c, lo[i]);
  }
  int j = 0;
  for (int dx = 0; dx < 2; ++dx) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dz = 0; dz < 2; ++dz, ++j) {
        const float f[3] = {lo[0] + dx, lo[1] + dy, lo[2] + dz};
        const int d[3] = {dx, dy, dz};
        bool ok = true;
        int flat = 0;
        float wt = 1.f;
        for (int i = 0; i < 3; ++i) {
          const float hi = (float)(size[i] - 1);
          ok = ok && f[i] >= 0.f && f[i] <= hi;
          flat = flat * size[i] + (int)fminf(fmaxf(f[i], 0.f), hi);
          const float wi = d[i] ? frac[i] : __fsub_rn(1.f, frac[i]);
          wt = i == 0 ? wi : __fmul_rn(wt, wi);
        }
        w[j] = ok ? wt : 0.f;
        idx[j] = flat;
      }
    }
  }
}

// acc = 0; acc += w_k * (label_k == id) for k = 0..7: adding 0 leaves acc
// (>= 0) unchanged, so a non-matching corner is skipped
__device__ __forceinline__ float slot_sum(const float (&w)[8], const int (&lab)[8], int id) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lab[j] == id) acc = __fadd_rn(acc, w[j]);
  return acc;
}

// The np (<= PPT) points from pts: weights and labels, every label load
// issued before any is used; with QUADS a corner pair along z (q, q + 1) in
// one aligned 16-byte quad of the grid is read with one load
template <int PPT, bool QUADS>
__device__ __forceinline__ void point_labels(const int* __restrict__ grid,
                                             const float* __restrict__ pts, int np, int Xg,
                                             int Yg, int Zg, int align, int border,
                                             float (&w)[PPT][8], int (&lab)[PPT][8]) {
  int idx[PPT][8];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    if (p < np) {
      point_corners(pts + p * 3, Xg, Yg, Zg, align, border, w[p], idx[p]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[p][j] = 0.f;
        idx[p][j] = 0;
      }
    }
  }
  const bool quads = QUADS && ((uintptr_t)grid & 15) == 0;
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int q = 0; q < 8; q += 2) {
      const int i0 = idx[p][q], i1 = idx[p][q + 1];
      if (quads && i1 == i0 + 1 && (i0 & 3) != 3) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(grid + (i0 & ~3)));
        const int k = i0 & 3;
        lab[p][q] = k == 0 ? v.x : k == 1 ? v.y : v.z;
        lab[p][q + 1] = k == 0 ? v.y : k == 1 ? v.z : v.w;
      } else {
        lab[p][q] = __ldg(grid + i0);
        lab[p][q + 1] = __ldg(grid + i1);
      }
    }
}

// out[0 .. np) of one slot: one vector store when `vec`, else one at a time
template <int PPT>
__device__ __forceinline__ void store_points(float* o, const float (&v)[PPT], int np, bool vec) {
  if constexpr (PPT == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < PPT; ++p)
    if (p < np) o[p] = v[p];
}

constexpr int SHARED_PPT = 1;    // points a thread, shared kernel
constexpr int PER_SLOT_PPT = 2;  // points a thread, per-slot kernel (paired loads)

// grid: (ceil(S / (blockDim.x * SHARED_PPT)), N); dynamic shared memory: G ints
__global__ void __launch_bounds__(256) label_shared_kernel(
    const int* __restrict__ grid, const int* __restrict__ slot_ids,
    const float* __restrict__ pts, float* __restrict__ out, int S, int B, int G, int Xg,
    int Yg, int Zg, int align, int border) {
  constexpr int PPT = SHARED_PPT;
  extern __shared__ int ids[];
  const int n = blockIdx.y;
  const int b = n % B;
  for (int i = threadIdx.x; i < G; i += blockDim.x) ids[i] = slot_ids[b * G + i];
  __syncthreads();
  const int64_t s0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * PPT;
  if (s0 >= S) return;
  const int np = (int)min((int64_t)PPT, S - s0);
  float w[PPT][8];
  int lab[PPT][8];
  point_labels<PPT, false>(grid + (int64_t)b * Xg * Yg * Zg, pts + ((int64_t)n * S + s0) * 3,
                           np, Xg, Yg, Zg, align, border, w, lab);
  const bool vec = np == PPT && S % PPT == 0;
  float* o = out + (int64_t)n * G * S + s0;
  for (int g = 0; g < G; ++g) {
    const int id = ids[g];
    float v[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) v[p] = slot_sum(w[p], lab[p], id);
    store_points<PPT>(o + (int64_t)g * S, v, np, vec);
  }
}

// grid: (ceil(P / (blockDim.x * PER_SLOT_PPT)), G, N)
__global__ void __launch_bounds__(256) label_per_slot_kernel(
    const int* __restrict__ grid, const int* __restrict__ slot_ids,
    const float* __restrict__ pts, float* __restrict__ out, int P, int B, int G, int Xg,
    int Yg, int Zg, int align, int border) {
  constexpr int PPT = PER_SLOT_PPT;
  const int n = blockIdx.z;
  const int g = blockIdx.y;
  const int b = n % B;
  const int64_t p0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * PPT;
  if (p0 >= P) return;
  const int np = (int)min((int64_t)PPT, P - p0);
  const int64_t row = ((int64_t)n * G + g) * P + p0;
  float w[PPT][8];
  int lab[PPT][8];
  point_labels<PPT, true>(grid + (int64_t)b * Xg * Yg * Zg, pts + row * 3, np, Xg, Yg, Zg,
                          align, border, w, lab);
  const int id = slot_ids[b * G + g];
  float v[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) v[p] = slot_sum(w[p], lab[p], id);
  store_points<PPT>(out + row, v, np, np == PPT && P % PPT == 0);
}

// Plain C entry points, loaded with ctypes.  Pointers are device pointers:
// grid int32 [B, Xg, Yg, Zg] (fewer than 2^31 labels per grid), slot_ids
// int32 [B, G], pts float32 [N, S, 3] (shared) or [N, G, S, 3] (per-slot),
// out float32 [N, G, S], 8-byte aligned.  N must be a multiple of B.  Each
// launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted), or cudaErrorInvalidValue for anything else.
static const int kThreads = 256;

static bool bad_args(int N, int B, int Xg, int Yg, int Zg, const void* out) {
  return N > 65535 || B <= 0 || (int64_t)Xg * Yg * Zg >= ((int64_t)1 << 31) ||
         (uintptr_t)out % 8 != 0;
}

static unsigned point_blocks(int S, int ppt) {
  return (unsigned)((S + (int64_t)kThreads * ppt - 1) / ((int64_t)kThreads * ppt));
}

extern "C" int label_gather3d_shared(const void* grid, const void* slot_ids,
                                     const void* pts, void* out, int N, int S,
                                     int B, int G, int Xg, int Yg, int Zg,
                                     int align, int border, void* stream) {
  if ((int64_t)N * S * G == 0) return 0;
  if (bad_args(N, B, Xg, Yg, Zg, out) || G > 12288) return (int)cudaErrorInvalidValue;
  label_shared_kernel<<<dim3(point_blocks(S, SHARED_PPT), N), kThreads, G * sizeof(int),
                        (cudaStream_t)stream>>>((const int*)grid, (const int*)slot_ids,
                                                (const float*)pts, (float*)out, S, B, G, Xg,
                                                Yg, Zg, align, border);
  return (int)cudaGetLastError();
}

extern "C" int label_gather3d_per_slot(const void* grid, const void* slot_ids,
                                       const void* pts, void* out, int N, int S,
                                       int B, int G, int Xg, int Yg, int Zg,
                                       int align, int border, void* stream) {
  if ((int64_t)N * S * G == 0) return 0;
  if (bad_args(N, B, Xg, Yg, Zg, out) || G > 65535) return (int)cudaErrorInvalidValue;
  label_per_slot_kernel<<<dim3(point_blocks(S, PER_SLOT_PPT), G, N), kThreads, 0,
                          (cudaStream_t)stream>>>((const int*)grid, (const int*)slot_ids,
                                                  (const float*)pts, (float*)out, S, B, G,
                                                  Xg, Yg, Zg, align, border);
  return (int)cudaGetLastError();
}
