// Counting sort of items by an integer key on the card, hand-written (no
// library call), with every key's entries in ascending item order: the same
// order on every call, as a stable sort gives.  Shared by K2-bwd
// (trilerp_sample3d.cu: a point's corner voxels on the wide-row path, its
// (x, y) column on the narrow-row path) and S1 (voxel_splat.cu: a frustum
// point's voxel).  Steps 1-3 with an entry per (item, key) instead of the
// item's index (segment_bin, below) are the binning of ordered_rows.cuh
// (K1-bwd and K4-bwd), which orders each key's span itself.
//
// The caller describes its items with a Keys type:
//   using Entry = ...;                what a key's list holds per item
//   template <class Fn> __device__ void operator()(int64_t i, Fn fn) const;
//                                     fn(key) for each key of item i (none,
//                                     one or several, each at most once)
//   __device__ Entry entry(int64_t i) const;   item i's entry
// and segment_sort() builds, for n_keys keys,
//   offs[k] .. offs[k + 1]   key k's span of `sorted` (offs has n_keys + 1)
//   sorted[...]              the entries, each key's in ascending item order
// in four steps, each one or a few kernel launches:
//   1. count: hist[key] += 1 (int32 atomics) for every key of every item;
//   2. offsets: an exclusive scan of the histogram (a block scan of
//      SCAN_TILE entries per block, a one-block scan of the block sums, an
//      add pass that also copies the offsets to the fill's cursor);
//   3. fill: each (item, key) pair writes the item's index to a slot of its
//      key's span taken through an int32 cursor (atomics, so the order is
//      arbitrary);
//   4. rank: each pair counts the indices of its span below its item's and
//      writes the item's entry at that rank (O(L^2) over a span of L).
// Every kernel is a template on Keys, so that the profiler names each
// caller's launches apart (scan_tiles_kernel<ColumnKeys>, ...).
//
// Include after <cuda_runtime.h> and <stdint.h>.

#pragma once

// 1. count
template <class Keys>
__global__ void seg_count_kernel(Keys keys, int* __restrict__ hist, int64_t n_items) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items; i += stride)
    keys(i, [&](int64_t k, auto&&...) { atomicAdd(hist + k, 1); });
}

// 2. offsets
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// Exclusive scan of one int per thread over the block (blockDim.x ==
// SCAN_THREADS); *total receives the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sums[lane];  // SCAN_THREADS / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sums[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int prefix = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[SCAN_THREADS / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return prefix;
}

// In place: each SCAN_TILE-entry tile of data[0, n) becomes its exclusive
// scan; tile_sums[tile] = the tile's sum.
template <class Keys>
__global__ void scan_tiles_kernel(int* __restrict__ data, int64_t n,
                                  int* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = base + k < n ? data[base + k] : 0;
    sum += v[k];
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < n) data[base + k] = run;
    run += v[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: in-place exclusive scan of sums[0, n), a tile at a time.
template <class Keys>
__global__ void scan_sums_kernel(int* __restrict__ sums, int64_t n) {
  int carry = 0;
  for (int64_t start = 0; start < n; start += SCAN_TILE) {
    const int64_t base = start + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = base + k < n ? sums[base + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (base + k < n) sums[base + k] = run;
      run += v[k];
    }
    carry += total;
  }
}

// data[i] += its tile's offset; copy[i] = the result for i < n - 1 (the
// fill's cursor)
template <class Keys>
__global__ void add_tile_offsets_kernel(int* __restrict__ data, int64_t n,
                                        const int* __restrict__ tile_sums,
                                        int* __restrict__ copy) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = data[i] + tile_sums[i / SCAN_TILE];
    data[i] = v;
    if (i < n - 1) copy[i] = v;
  }
}

// 3. fill
template <class Keys>
__global__ void seg_fill_kernel(Keys keys, int* __restrict__ cursor, int* __restrict__ idx,
                                int64_t n_items) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items; i += stride)
    keys(i, [&](int64_t k) { idx[atomicAdd(cursor + k, 1)] = (int)i; });
}

// 4. rank (an item has at most one entry per key, so the ranks within a span
// are distinct)
template <class Keys>
__global__ void seg_rank_kernel(Keys keys, const int* __restrict__ offs,
                                const int* __restrict__ idx,
                                typename Keys::Entry* __restrict__ sorted, int64_t n_items) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items; i += stride)
    keys(i, [&](int64_t k) {
      const int beg = offs[k], end = offs[k + 1];
      const int me = (int)i;
      int rank = 0;
      for (int j = beg; j < end; ++j) rank += idx[j] < me;
      sorted[beg + rank] = keys.entry(i);
    });
}

// blocks of `threads` for n threads, at most 2^30 (grid-stride loops take
// the rest)
static inline unsigned grid_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return (unsigned)blocks;
}

static inline int64_t scan_tile_count(int64_t n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

// int32s before the entries: offsets, cursor, tile sums and the fill's item
// indices, rounded up to a multiple of 4 so that entries of up to 16 bytes
// are aligned.
static inline int64_t segment_sort_head(int64_t n_keys, int64_t n_entries) {
  return (2 * n_keys + 1 + scan_tile_count(n_keys + 1) + n_entries + 3) & ~(int64_t)3;
}

// int32s of segment_sort's workspace for n_keys keys and up to n_entries
// entries of entry_ints ints each.
static inline int64_t segment_sort_ints(int64_t n_keys, int64_t n_entries, int entry_ints) {
  return segment_sort_head(n_keys, n_entries) + entry_ints * n_entries;
}

// The workspace's parts, as segment_sort_ints lays them out.
template <class Entry>
struct SegmentSortSpace {
  int* offs;       // [n_keys + 1]
  int* cursor;     // [n_keys]
  int* tile_sums;  // [scan_tile_count(n_keys + 1)]
  int* idx;        // [n_entries], the fill's item indices
  Entry* sorted;   // [n_entries]
};

template <class Entry>
static inline SegmentSortSpace<Entry> segment_sort_space(void* workspace, int64_t n_keys,
                                                         int64_t n_entries) {
  SegmentSortSpace<Entry> s;
  s.offs = (int*)workspace;
  s.cursor = s.offs + n_keys + 1;
  s.tile_sums = s.cursor + n_keys;
  s.idx = s.tile_sums + scan_tile_count(n_keys + 1);
  s.sorted = (Entry*)(s.offs + segment_sort_head(n_keys, n_entries));
  return s;
}

// Steps 1-2: offs[0 .. n_keys] the exclusive scan of every key's count,
// cursor[0 .. n_keys) a copy of it (tile_sums scratch).  Returns the first
// CUDA error.
template <class Keys>
static cudaError_t segment_offsets(const Keys& keys, int64_t n_items, int64_t n_keys, int* offs,
                                   int* cursor, int* tile_sums, cudaStream_t st) {
  const int threads = 256;
  cudaError_t err = cudaMemsetAsync(offs, 0, (n_keys + 1) * sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (n_items > 0)
    seg_count_kernel<Keys><<<grid_blocks(n_items, threads), threads, 0, st>>>(keys, offs,
                                                                             n_items);
  const int64_t tiles = scan_tile_count(n_keys + 1);
  scan_tiles_kernel<Keys><<<(unsigned)tiles, SCAN_THREADS, 0, st>>>(offs, n_keys + 1,
                                                                    tile_sums);
  scan_sums_kernel<Keys><<<1, SCAN_THREADS, 0, st>>>(tile_sums, tiles);
  add_tile_offsets_kernel<Keys><<<grid_blocks(n_keys + 1, threads), threads, 0, st>>>(
      offs, n_keys + 1, tile_sums, cursor);
  return cudaGetLastError();
}

// Steps 1-4 for n_items items over n_keys keys (n_keys + 1 and the entries
// below 2^31), on `st`: afterwards s.offs and s.sorted hold each key's
// entries in ascending item order (s.idx and s.cursor are scratch).
// Returns the first CUDA error.
template <class Keys>
static cudaError_t segment_sort(const Keys& keys, int64_t n_items, int64_t n_keys,
                                const SegmentSortSpace<typename Keys::Entry>& s,
                                cudaStream_t st) {
  const int threads = 256;
  cudaError_t err = segment_offsets(keys, n_items, n_keys, s.offs, s.cursor, s.tile_sums, st);
  if (err != cudaSuccess) return err;
  if (n_items > 0) {
    seg_fill_kernel<Keys><<<grid_blocks(n_items, threads), threads, 0, st>>>(keys, s.cursor,
                                                                            s.idx, n_items);
    seg_rank_kernel<Keys><<<grid_blocks(n_items, threads), threads, 0, st>>>(
        keys, s.offs, s.idx, s.sorted, n_items);
  }
  return cudaGetLastError();
}

// ---- binning: steps 1-3 with an entry per (item, key) ----
//
// For a Keys type whose operator() calls fn(key, entry) (an entry of its
// own for each key of the item; Keys::Entry its type), segment_bin() leaves
// each key's entries in its span of `entries`, offs[k] .. offs[k + 1], in
// an order that changes from call to call (the fill's cursor atomics): the
// caller orders each span itself.  Its workspace is the int32 head
// (offsets, cursor, tile sums) of segment_bin_head_ints, then the entries.

// 3. fill, each (item, key) pair writing its own entry
template <class Keys>
__global__ void seg_fill_entries_kernel(Keys keys, int* __restrict__ cursor,
                                        typename Keys::Entry* __restrict__ entries,
                                        int64_t n_items) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items; i += stride)
    keys(i, [&](int64_t k, const typename Keys::Entry& e) {
      entries[atomicAdd(cursor + k, 1)] = e;
    });
}

// int32s of segment_bin's head for n_keys keys
static inline int64_t segment_bin_head_ints(int64_t n_keys) {
  return 2 * n_keys + 1 + scan_tile_count(n_keys + 1);
}

// Steps 1-3 for n_items items over n_keys keys (n_keys + 1 and the entries
// below 2^31): offs [n_keys + 1], cursor [n_keys] and tile_sums
// [scan_tile_count(n_keys + 1)] back to back from `head`.  Returns the first
// CUDA error.
template <class Keys>
static cudaError_t segment_bin(const Keys& keys, int64_t n_items, int64_t n_keys, int* head,
                               typename Keys::Entry* entries, cudaStream_t st) {
  const int threads = 256;
  int* cursor = head + n_keys + 1;
  cudaError_t err = segment_offsets(keys, n_items, n_keys, head, cursor, cursor + n_keys, st);
  if (err != cudaSuccess) return err;
  if (n_items > 0)
    seg_fill_entries_kernel<Keys><<<grid_blocks(n_items, threads), threads, 0, st>>>(
        keys, cursor, entries, n_items);
  return cudaGetLastError();
}
