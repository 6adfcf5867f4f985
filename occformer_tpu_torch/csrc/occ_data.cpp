// Native data-pipeline kernels of the port's nuScenes pipeline.
//
// The port's copy of csrc/occ_data.cpp, the CPU-side data hot loops of the
// reference: the numba majority-vote voxelizer (loading_nusc_occ.py:122-138
// / loading_nusc_panoptic_occ.py:148-170), the LiDAR->depth z-buffer
// (lidar2depth.py:39-87) and SemanticKITTI voxel bit packing
// (tools/kitti_process/io_data.py).  Exposed through a C ABI and loaded with
// ctypes (occformer_tpu_torch/data/native.py), which builds it with g++ at
// first use and raises when it cannot; the numpy versions beside each call
// are the plain versions the tests hold it against.
//
// Build: g++ -O3 -march=native -shared -fPIC occ_data.cpp -o libocc_data.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Majority-vote labels into voxels.
//   flat_idx: [n] linear voxel index per point (precomputed, in range)
//   labels:   [n] integer labels (0 .. label_space-1)
//   out:      [n_voxels] prefilled with the empty id by the caller
// suppress_zero: label 0 never outvotes a real label (panoptic kernel rule).
// Tie-break: smallest label wins (argmax-first semantics of the reference).
void majority_vote(const int64_t* flat_idx, const int64_t* labels, int64_t n,
                   int64_t n_voxels, int32_t suppress_zero, int64_t* out) {
  if (n == 0) return;
  std::vector<std::pair<int64_t, int64_t>> pairs(n);
  for (int64_t i = 0; i < n; ++i) pairs[i] = {flat_idx[i], labels[i]};
  std::sort(pairs.begin(), pairs.end());

  int64_t i = 0;
  while (i < n) {
    const int64_t vox = pairs[i].first;
    int64_t best_label = -1, best_count = -1;
    int64_t zero_label = -1;
    while (i < n && pairs[i].first == vox) {
      const int64_t lab = pairs[i].second;
      int64_t cnt = 0;
      while (i < n && pairs[i].first == vox && pairs[i].second == lab) {
        ++cnt;
        ++i;
      }
      if (suppress_zero && lab == 0) {
        zero_label = 0;  // remember zero exists, but never let it outvote
        continue;
      }
      if (cnt > best_count) {  // strict: ties keep the earlier (smaller) label
        best_count = cnt;
        best_label = lab;
      }
    }
    if (best_label < 0) best_label = (zero_label == 0) ? 0 : best_label;
    if (best_label >= 0 && vox >= 0 && vox < n_voxels) out[vox] = best_label;
  }
}

// Z-buffered sparse depth rendering: nearest return wins.
//   u, v: [n] integer pixel coords; d: [n] depths; valid: [n] 0/1
//   depth: [h * w] prefilled with 0
void zbuffer_depth(const int32_t* u, const int32_t* v, const float* d,
                   const uint8_t* valid, int64_t n, int64_t h, int64_t w,
                   float* depth) {
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const int64_t idx = (int64_t)v[i] * w + u[i];
    if (idx < 0 || idx >= h * w) continue;
    const float cur = depth[idx];
    if (cur == 0.0f || d[i] < cur) depth[idx] = d[i];
  }
}

// MSB-first bit unpack (KITTI .bin/.invalid voxel masks).
void unpack_bits(const uint8_t* bytes, int64_t n_bytes, uint8_t* bits) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    const uint8_t b = bytes[i];
    for (int k = 0; k < 8; ++k) bits[i * 8 + k] = (b >> (7 - k)) & 1;
  }
}

void pack_bits(const uint8_t* bits, int64_t n_bits, uint8_t* bytes) {
  std::memset(bytes, 0, (n_bits + 7) / 8);
  for (int64_t i = 0; i < n_bits; ++i) {
    if (bits[i]) bytes[i / 8] |= (uint8_t)(1 << (7 - (i % 8)));
  }
}

}  // extern "C"
