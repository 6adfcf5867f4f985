// Typed chunk loads and stores shared by the narrow-row kernels of
// trilerp_sample3d.cu (K2, K2-bwd), voxel_splat.cu (S1) and the row
// kernels of ordered_rows.cuh, ms_deform_gather3d.cu (K1-bwd) and
// multilevel_gather3d.cu (K4-bwd): a chunk of VEC elements moved as one
// load or store of VEC * sizeof(element) bytes, its sums kept in float32.
//
// Include after <cuda_bf16.h>, <stdint.h> and <string.h>.

#pragma once

// The raw word of one load of B bytes.
template <int B> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = unsigned; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) { d = __float2bfloat16(v); }

// a += w * (the VEC elements of one loaded chunk, as float)
template <typename Tin, int VEC, typename R>
__device__ __forceinline__ void fma_chunk(float (&a)[VEC], const R& r, float w) {
  static_assert(sizeof(R) == VEC * sizeof(Tin), "chunk size");
  Tin e[VEC];
  memcpy(e, &r, sizeof(R));
#pragma unroll
  for (int k = 0; k < VEC; ++k) a[k] = fmaf(w, to_f(e[k]), a[k]);
}

// the VEC elements of one loaded chunk, as float
template <typename Tin, int VEC, typename R>
__device__ __forceinline__ void chunk_floats(float (&a)[VEC], const R& r) {
  static_assert(sizeof(R) == VEC * sizeof(Tin), "chunk size");
  Tin e[VEC];
  memcpy(e, &r, sizeof(R));
#pragma unroll
  for (int k = 0; k < VEC; ++k) a[k] = to_f(e[k]);
}

// the VEC sums rounded once to the output's type, as one store
template <typename Tout, int VEC>
__device__ __forceinline__ void store_chunk(Tout* p, const float (&a)[VEC]) {
  using R = typename Raw<VEC * sizeof(Tout)>::T;
  Tout e[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) from_f(e[k], a[k]);
  R r;
  memcpy(&r, e, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}
