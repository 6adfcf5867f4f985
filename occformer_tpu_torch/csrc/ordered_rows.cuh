// Trilinear-gather gradients summed in a fixed order, with no float
// atomics: the d_value of K1-bwd (ms_deform_gather3d.cu) and the d_tables of
// K4-bwd (multilevel_gather3d.cu), each
//
//   dst[row, :] = sum over the samples with a corner in the row of
//                 weight * src[sample's src row, :]
//
// rounded once to dst's type; a row that no sample touches gets zeros.
// Each sample is binned once, by its lower corner (x0, y0, z0) (the corner
// of lerp weight 1 - w1 on every axis; x0 in [-1, X - 1], ... for a sample
// with a corner inside its level), as an entry (sample, w1x, w1y, w1z).  A
// row (x, y, z) is corner (dx, dy, dz) of exactly the samples of the bin
// (x - dx, y - dy, z - dz), so it walks its 8 neighbour bins in corner
// order q = dx * 4 + dy * 2 + dz, each bin's samples in ascending order,
// and adds weight * src with the corner weight rebuilt from the entry's w1
// (w0 = 1 - w1, as the forward computes it): the same order on every call,
// so two calls give the same bits.
//
// The caller describes its samples with three types:
//   Keys: segment_sort.cuh's binning functor, fn(bin, BinEntry) for a
//         sample with a corner inside its level, nothing otherwise;
//   Geo:  __device__ void bins(int64_t row, int64_t (&b)[8]) const: the
//         row's 8 neighbour bins in corner order; int64_t src(int item)
//         const: the sample's src row; float weight(float scale, float wx,
//         float wy, float wz) const: the term's weight from the sample's
//         scale and the corner's three lerp weights; kScaled, and then
//         float scale(int item) const: the sample's scale (else 1);
//   Cand: __device__ int64_t count(int64_t bin) const and int item(int64_t
//         bin, int64_t t) const: the samples that could fall in the bin, in
//         ascending order (for bins too full to sort in shared memory).
// ordered_rows_sum() runs:
//   1-3. segment_bin: the entries binned, each bin's span in an order that
//        changes from call to call (the fill's cursor atomics);
//   4. order each span by sample: span_sort_warp_kernel, a warp per bin of
//      at most WARP_SPAN entries, ranks them against the bin's samples
//      staged in shared memory and writes each at its rank; it lists the
//      fuller bins, those of at most BLOCK_SPAN for span_sort_block_kernel
//      (a block per bin: a bitonic sort of (sample, slot) pairs in shared
//      memory, then the entries rewritten in that order), the rest for
//      heavy_bins_kernel (a block per bin rescans the bin's candidate
//      samples in ascending order and writes the members by a block scan);
//   4d. entry_scale_kernel (kScaled only): every entry's scale gathered once
//      into entry order, so that the reduce reads it with its entry;
//   5. corner_reduce_kernel: a thread per (row, chunk of VEC channels) walks
//      the 8 neighbour bins as one sequence of terms, REDUCE_UNROLL at a
//      time (their entries, then their src chunks and scales, loaded before
//      the FMAs), sums in float32 and stores the chunk once.
// One entry per sample (not per corner) keeps the binning to the samples'
// count: 3.6 M entries of 16 bytes at the flagship, 57 MB, and their scales
// 14 MB.  A scale read per term from the sample's own array cost a 32-byte
// L2 sector per term (28.7 M at the flagship); read in entry order, eight
// terms of a bin share one.
//
// Include after <cuda_bf16.h>, <cuda_runtime.h>, <stdint.h> and <string.h>.

#pragma once

#include <limits.h>

#include "chunk_io.cuh"
#include "segment_sort.cuh"

struct __align__(16) BinEntry {
  int item;    // the sample
  float w1[3]; // the upper corner's lerp weight on x, y and z
};

constexpr int WARP_SPAN = 128;    // bins of at most this many entries: a warp ranks them
constexpr int BLOCK_SPAN = 2048;  // at most this many: a block sorts them; more: heavy
constexpr int SORT_THREADS = 256;
constexpr int REDUCE_UNROLL = 8;  // entries whose src chunks a thread loads at a time
constexpr int HEAVY_BLOCKS = 132;
constexpr int LONG_BLOCKS = 1056;

// The workspace: int32s from `ws`, as ordered_rows_ints lays them out.
struct OrderedRowsSpace {
  int* head;        // segment_bin's offsets, cursor and tile sums; offs = head
  int* long_bins;   // [n_bins]
  int* heavy_bins;  // [n_bins]
  int* counts;      // [2]: long bins, heavy bins
  BinEntry* entries;
  float* scales;    // [n_items]: entry j's scale (kScaled)
};

static inline int64_t ordered_rows_head(int64_t n_bins) {
  return (segment_bin_head_ints(n_bins) + 2 * n_bins + 2 + 3) & ~(int64_t)3;
}

// int32s of the workspace for n_bins bins and up to n_items entries
static inline int64_t ordered_rows_ints(int64_t n_bins, int64_t n_items) {
  return ordered_rows_head(n_bins) + 5 * n_items;
}

static inline OrderedRowsSpace ordered_rows_space(void* ws, int64_t n_bins, int64_t n_items) {
  OrderedRowsSpace s;
  s.head = (int*)ws;
  s.long_bins = s.head + segment_bin_head_ints(n_bins);
  s.heavy_bins = s.long_bins + n_bins;
  s.counts = s.heavy_bins + n_bins;
  s.entries = (BinEntry*)(s.head + ordered_rows_head(n_bins));
  s.scales = (float*)(s.entries + n_items);
  return s;
}

// 4a. a warp per bin: spans of 2..WARP_SPAN entries ranked and rewritten in
// place; fuller bins listed.  The sort kernels are templates on the caller's
// Keys, so that the profiler names each caller's launches apart.
template <class Keys>
__global__ void __launch_bounds__(SORT_THREADS) span_sort_warp_kernel(
    const int* __restrict__ offs, BinEntry* __restrict__ entries, int64_t n_bins,
    int* __restrict__ long_bins, int* __restrict__ heavy_bins, int* __restrict__ counts) {
  constexpr int K = WARP_SPAN / 32;
  __shared__ int items[SORT_THREADS / 32][WARP_SPAN];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t warps = (int64_t)gridDim.x * (SORT_THREADS / 32);
  for (int64_t r = (int64_t)blockIdx.x * (SORT_THREADS / 32) + wib; r < n_bins; r += warps) {
    const int beg = offs[r], n = offs[r + 1] - beg;
    if (n <= 1) continue;
    if (n > WARP_SPAN) {
      if (lane == 0) {
        if (n <= BLOCK_SPAN) long_bins[atomicAdd(counts, 1)] = (int)r;
        else heavy_bins[atomicAdd(counts + 1, 1)] = (int)r;
      }
      continue;
    }
    BinEntry e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      e[k].item = INT_MAX;
      if (j < n) {
        e[k] = entries[beg + j];
        items[wib][j] = e[k].item;
      }
    }
    __syncwarp();
    int rank[K];
#pragma unroll
    for (int k = 0; k < K; ++k) rank[k] = 0;
    for (int m = 0; m < n; ++m) {
      const int it = items[wib][m];
#pragma unroll
      for (int k = 0; k < K; ++k) rank[k] += it < e[k].item;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k < n) entries[beg + rank[k]] = e[k];
    __syncwarp();  // items[wib] is the next bin's
  }
}

// 4b. a block per listed bin of at most BLOCK_SPAN entries: bitonic sort of
// (sample, slot) pairs (padded to a power of two) in shared memory, then the
// span rewritten from its staged copy in that order
template <class Keys>
__global__ void __launch_bounds__(SORT_THREADS) span_sort_block_kernel(
    const int* __restrict__ offs, BinEntry* __restrict__ entries,
    const int* __restrict__ long_bins, const int* __restrict__ counts) {
  __shared__ BinEntry buf[BLOCK_SPAN];
  __shared__ int key[BLOCK_SPAN];
  __shared__ short slot[BLOCK_SPAN];
  const int n_long = counts[0];
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int r = long_bins[i];
    const int beg = offs[r], n = offs[r + 1] - beg;
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (int j = threadIdx.x; j < p2; j += blockDim.x) {
      if (j < n) {
        buf[j] = entries[beg + j];
        key[j] = buf[j].item;
      } else {
        key[j] = INT_MAX;
      }
      slot[j] = (short)j;
    }
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < (p2 >> 1); t += blockDim.x) {
          const int a = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const int b = a + j;
          const int ka = key[a], kb = key[b];
          if ((ka > kb) == ((a & k) == 0)) {
            key[a] = kb;
            key[b] = ka;
            const short sa = slot[a];
            slot[a] = slot[b];
            slot[b] = sa;
          }
        }
        __syncthreads();
      }
    for (int j = threadIdx.x; j < n; j += blockDim.x) entries[beg + j] = buf[slot[j]];
    __syncthreads();
  }
}

// 4c. a block of SCAN_THREADS per heavy bin: the bin's candidate samples
// scanned in ascending order, its members written in that order
template <class Keys, class Cand>
__global__ void __launch_bounds__(SCAN_THREADS) heavy_bins_kernel(
    Keys keys, Cand cand, const int* __restrict__ offs, BinEntry* __restrict__ entries,
    const int* __restrict__ heavy_bins, const int* __restrict__ counts) {
  const int n_heavy = counts[1];
  for (int i = blockIdx.x; i < n_heavy; i += gridDim.x) {
    const int64_t bin = heavy_bins[i];
    const int64_t m = cand.count(bin);
    int pos = offs[bin];
    for (int64_t t0 = 0; t0 < m; t0 += blockDim.x) {
      const int64_t t = t0 + threadIdx.x;
      int flag = 0;
      BinEntry e;
      if (t < m)
        keys(cand.item(bin, t), [&](int64_t k, const BinEntry& x) {
          if (k == bin) {
            flag = 1;
            e = x;
          }
        });
      int total;
      const int at = block_exclusive_scan(flag, &total);
      if (flag) entries[pos + at] = e;
      pos += total;
    }
  }
}

// 4d. scales[j] = the scale of entry j's sample, for the offs[n_bins]
// entries binned
template <class Geo>
__global__ void entry_scale_kernel(Geo geo, const int* __restrict__ n_binned,
                                   const BinEntry* __restrict__ entries,
                                   float* __restrict__ scales) {
  const int n = *n_binned;
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride)
    scales[j] = geo.scale(entries[j].item);
}

// 5. thread (row, chunk): the row's 8 neighbour bins in corner order, each
// in ascending sample order, walked as one sequence of terms (the 16 bin
// offsets loaded together first), U terms' loads issued at a time
template <typename T, int VEC, class Geo>
__global__ void __launch_bounds__(256) corner_reduce_kernel(
    Geo geo, const int* __restrict__ offs, const BinEntry* __restrict__ entries,
    const float* __restrict__ scales, const T* __restrict__ src, T* __restrict__ dst,
    int64_t n_rows, int C) {
  using R = typename Raw<VEC * sizeof(T)>::T;
  constexpr int U = REDUCE_UNROLL;
  const int nchunk = C / VEC;
  const int64_t n_work = n_rows * nchunk;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n_work; t += stride) {
    const int chunk = (int)(t % nchunk);
    const int64_t r = t / nchunk;
    int64_t bins[8];
    geo.bins(r, bins);
    int beg[8], end[8], cum[8];  // cum[q]: the terms of the bins before q
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      beg[q] = offs[bins[q]];
      end[q] = offs[bins[q] + 1];
    }
    cum[0] = 0;
#pragma unroll
    for (int q = 1; q < 8; ++q) cum[q] = cum[q - 1] + end[q - 1] - beg[q - 1];
    const int n = cum[7] + end[7] - beg[7];
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const T* sc = src + chunk * VEC;
    for (int k0 = 0; k0 < n; k0 += U) {
      BinEntry e[U];
      int qu[U];  // the term's corner: its bin
      R raw[U] = {};
      float a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        qu[u] = 0;
        int j = beg[0] + k;
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (k >= cum[q]) {
            qu[u] = q;
            j = beg[q] + (k - cum[q]);
          }
        a[u] = 1.f;
        if (k < n) {
          e[u] = entries[j];
          if constexpr (Geo::kScaled) a[u] = scales[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u < n) raw[u] = *reinterpret_cast<const R*>(sc + geo.src(e[u].item) * C);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u < n) {
          const int q = qu[u];
          const float wx = (q >> 2) ? e[u].w1[0] : 1.f - e[u].w1[0];
          const float wy = ((q >> 1) & 1) ? e[u].w1[1] : 1.f - e[u].w1[1];
          const float wz = (q & 1) ? e[u].w1[2] : 1.f - e[u].w1[2];
          fma_chunk<T, VEC>(acc, raw[u], geo.weight(a[u], wx, wy, wz));
        }
    }
    store_chunk<T, VEC>(dst + r * C + chunk * VEC, acc);
  }
}

// The widest chunk (elements, a power of two, at most 16 bytes) that divides
// C and at which every pointer is aligned.
static inline int row_chunk(int C, int esize, const void* const* ptrs, int n_ptrs) {
  int vec = 16 / esize;
  for (;;) {
    bool ok = C % vec == 0;
    for (int i = 0; i < n_ptrs; ++i) ok = ok && (uintptr_t)ptrs[i] % (vec * esize) == 0;
    if (ok || vec == 1) return vec;
    vec >>= 1;
  }
}

template <typename T, int VEC, class Geo>
static void launch_corner_reduce(const Geo& geo, const OrderedRowsSpace& s, const T* src, T* dst,
                                 int64_t n_rows, int C, cudaStream_t st) {
  const int threads = 256;
  corner_reduce_kernel<T, VEC, Geo><<<grid_blocks(n_rows * (C / VEC), threads), threads, 0, st>>>(
      geo, s.head, s.entries, s.scales, src, dst, n_rows, C);
}

// Steps 1-5: dst [n_rows, C] (T) written in full from src [*, C] (T) and
// n_items samples binned into n_bins bins; `vec` from row_chunk over src
// and dst.  n_bins + 1 and n_items must lie below 2^31.  Returns the first
// CUDA error, or cudaErrorInvalidValue for a `vec` the type does not take.
template <typename T, class Keys, class Geo, class Cand>
static cudaError_t ordered_rows_sum(const Keys& keys, int64_t n_items, const Geo& geo,
                                    const Cand& cand, int64_t n_bins, int64_t n_rows, int C,
                                    int vec, const T* src, T* dst, const OrderedRowsSpace& s,
                                    cudaStream_t st) {
  if (n_rows == 0 || C == 0) return cudaSuccess;
  cudaError_t err = segment_bin(keys, n_items, n_bins, s.head, s.entries, st);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(s.counts, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return err;
  span_sort_warp_kernel<Keys><<<grid_blocks(n_bins * 32, SORT_THREADS), SORT_THREADS, 0, st>>>(
      s.head, s.entries, n_bins, s.long_bins, s.heavy_bins, s.counts);
  span_sort_block_kernel<Keys><<<LONG_BLOCKS, SORT_THREADS, 0, st>>>(s.head, s.entries,
                                                                     s.long_bins, s.counts);
  heavy_bins_kernel<Keys, Cand><<<HEAVY_BLOCKS, SCAN_THREADS, 0, st>>>(
      keys, cand, s.head, s.entries, s.heavy_bins, s.counts);
  if constexpr (Geo::kScaled)
    if (n_items > 0)
      entry_scale_kernel<Geo><<<grid_blocks(n_items, 256), 256, 0, st>>>(geo, s.head + n_bins,
                                                                         s.entries, s.scales);
  switch (vec * (int)sizeof(T)) {
    case 16: launch_corner_reduce<T, 16 / sizeof(T)>(geo, s, src, dst, n_rows, C, st); break;
    case 8: launch_corner_reduce<T, 8 / sizeof(T)>(geo, s, src, dst, n_rows, C, st); break;
    case 4: launch_corner_reduce<T, 4 / sizeof(T)>(geo, s, src, dst, n_rows, C, st); break;
    case 2:
      if (sizeof(T) != 2) return cudaErrorInvalidValue;
      launch_corner_reduce<T, 1>(geo, s, src, dst, n_rows, C, st);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
