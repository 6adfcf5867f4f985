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
// Design: one thread per point.  It computes the 8 weights and clamped
// indices once, reads the 8 labels (only those of live corners), and loops
// over the slots; the output is slot-major, so that neighbouring threads
// write neighbouring addresses.  The block's slot ids sit in shared memory.
//
// Bound on an H100 SXM at the flagship's candidate readout (N = 10 layers x
// samples, S = 150528, G = 17, int32 grid 256 x 256 x 32): points 18.1 MB
// and the grid 8.4 MB read, the output 102.4 MB written, about 129 MB, about
// 38 us at 3.35 TB/s; the compares (16 operations per point and slot) take
// a tenth of that.  The corner reads of random points mostly miss L1, but
// the 8.4 MB grid stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

struct Corners {
  float w[8];
  int64_t idx[8];
};

__device__ __forceinline__ Corners make_corners(const float* p, int Xg, int Yg,
                                                int Zg, int align, int border) {
  const int size[3] = {Xg, Yg, Zg};
  float lo[3], frac[3];
  for (int i = 0; i < 3; ++i) {
    const float n = (float)size[i];
    float c = align ? __fmul_rn(p[i], n - 1.f) : __fsub_rn(__fmul_rn(p[i], n), 0.5f);
    if (border) c = fminf(fmaxf(c, 0.f), n - 1.f);
    lo[i] = floorf(c);
    frac[i] = __fsub_rn(c, lo[i]);
  }
  Corners k;
  int j = 0;
  for (int dx = 0; dx < 2; ++dx) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dz = 0; dz < 2; ++dz, ++j) {
        const float f[3] = {lo[0] + dx, lo[1] + dy, lo[2] + dz};
        const int d[3] = {dx, dy, dz};
        bool ok = true;
        int64_t flat = 0;
        float w = 1.f;
        for (int i = 0; i < 3; ++i) {
          const float hi = (float)(size[i] - 1);
          ok = ok && f[i] >= 0.f && f[i] <= hi;
          flat = flat * size[i] + (int64_t)fminf(fmaxf(f[i], 0.f), hi);
          const float wi = d[i] ? frac[i] : __fsub_rn(1.f, frac[i]);
          w = i == 0 ? wi : __fmul_rn(w, wi);
        }
        k.w[j] = ok ? w : 0.f;
        k.idx[j] = ok ? flat : -1;
      }
    }
  }
  return k;
}

// acc = 0; acc += w_k * (label_k == id) for k = 0..7: adding 0 leaves acc
// (>= 0) unchanged, so a non-matching or dead corner is skipped
__device__ __forceinline__ float slot_sum(const Corners& k, const int* lab, int id) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k.idx[j] >= 0 && lab[j] == id) acc = __fadd_rn(acc, k.w[j]);
  return acc;
}

__device__ __forceinline__ void read_labels(const int* grid, const Corners& k,
                                            int* lab) {
#pragma unroll
  for (int j = 0; j < 8; ++j) lab[j] = k.idx[j] >= 0 ? __ldg(grid + k.idx[j]) : 0;
}

// grid: (ceil(S / blockDim.x), N); dynamic shared memory: G ints
__global__ void label_shared_kernel(const int* __restrict__ grid,
                                    const int* __restrict__ slot_ids,
                                    const float* __restrict__ pts,
                                    float* __restrict__ out, int S, int B, int G,
                                    int Xg, int Yg, int Zg, int align,
                                    int border) {
  extern __shared__ int ids[];
  const int n = blockIdx.y;
  const int b = n % B;
  for (int i = threadIdx.x; i < G; i += blockDim.x) ids[i] = slot_ids[b * G + i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const Corners k = make_corners(pts + ((int64_t)n * S + s) * 3, Xg, Yg, Zg,
                                 align, border);
  int lab[8];
  read_labels(grid + (int64_t)b * Xg * Yg * Zg, k, lab);
  float* o = out + (int64_t)n * G * S + s;
  for (int g = 0; g < G; ++g) o[(int64_t)g * S] = slot_sum(k, lab, ids[g]);
}

// grid: (ceil(P / blockDim.x), G, N)
__global__ void label_per_slot_kernel(const int* __restrict__ grid,
                                      const int* __restrict__ slot_ids,
                                      const float* __restrict__ pts,
                                      float* __restrict__ out, int P, int B,
                                      int G, int Xg, int Yg, int Zg, int align,
                                      int border) {
  const int n = blockIdx.z;
  const int g = blockIdx.y;
  const int b = n % B;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t row = ((int64_t)n * G + g) * P + p;
  const Corners k = make_corners(pts + row * 3, Xg, Yg, Zg, align, border);
  int lab[8];
  read_labels(grid + (int64_t)b * Xg * Yg * Zg, k, lab);
  out[row] = slot_sum(k, lab, slot_ids[b * G + g]);
}

// Plain C entry points, loaded with ctypes.  Pointers are device pointers:
// grid int32 [B, Xg, Yg, Zg], slot_ids int32 [B, G], pts float32 [N, S, 3]
// (shared) or [N, G, S, 3] (per-slot), out float32 [N, G, S].  N must be a
// multiple of B.  Each launches on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted).
static const int kThreads = 256;

extern "C" int label_gather3d_shared(const void* grid, const void* slot_ids,
                                     const void* pts, void* out, int N, int S,
                                     int B, int G, int Xg, int Yg, int Zg,
                                     int align, int border, void* stream) {
  if ((int64_t)N * S * G == 0) return 0;
  if (N > 65535 || B <= 0 || G > 12288) return (int)cudaErrorInvalidValue;
  const dim3 blocks((S + kThreads - 1) / kThreads, N);
  label_shared_kernel<<<blocks, kThreads, G * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)grid, (const int*)slot_ids, (const float*)pts, (float*)out, S,
      B, G, Xg, Yg, Zg, align, border);
  return (int)cudaGetLastError();
}

extern "C" int label_gather3d_per_slot(const void* grid, const void* slot_ids,
                                       const void* pts, void* out, int N, int S,
                                       int B, int G, int Xg, int Yg, int Zg,
                                       int align, int border, void* stream) {
  if ((int64_t)N * S * G == 0) return 0;
  if (N > 65535 || G > 65535 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 blocks((S + kThreads - 1) / kThreads, G, N);
  label_per_slot_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)grid, (const int*)slot_ids, (const float*)pts, (float*)out, S,
      B, G, Xg, Yg, Zg, align, border);
  return (int)cudaGetLastError();
}
