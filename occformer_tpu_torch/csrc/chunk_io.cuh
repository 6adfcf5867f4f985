// Typed chunk loads and stores shared by the narrow-row kernels of
// trilerp_sample3d.cu (K2, K2-bwd), voxel_splat.cu (S1) and the row
// kernels of ordered_rows.cuh, ms_deform_gather3d.cu (K1, K1-bwd) and
// multilevel_gather3d.cu (K4, K4-bwd): a chunk of VEC elements moved as one
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

// The row-wide forwards of K1 and K4 read a row as vectors of VB bytes (16,
// 8, 4 or 2) of float32 or bfloat16 elements, as raw words, and convert a
// bfloat16 pair with one instruction.

// The 32-bit words of a vector of 4, 8 or 16 bytes, and back.
__device__ __forceinline__ void vec_words(unsigned (&w)[1], unsigned r) { w[0] = r; }
__device__ __forceinline__ void vec_words(unsigned (&w)[2], const uint2& r) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void vec_words(unsigned (&w)[4], const uint4& r) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ unsigned words_vec(const unsigned (&w)[1]) { return w[0]; }
__device__ __forceinline__ uint2 words_vec(const unsigned (&w)[2]) {
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint4 words_vec(const unsigned (&w)[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a += w * (the VB / sizeof(T) elements of one vector, as float)
template <typename T, int VB>
__device__ __forceinline__ void fma_vec(float (&a)[VB / sizeof(T)],
                                        const typename Raw<VB>::T& r, float w) {
  if constexpr (VB == 2) {
    static_assert(sizeof(T) == 2, "a 2-byte vector is one bfloat16");
    a[0] = fmaf(w, __bfloat162float(__ushort_as_bfloat16(r)), a[0]);
  } else {
    unsigned wd[VB / 4];
    vec_words(wd, r);
#pragma unroll
    for (int k = 0; k < VB / 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        __nv_bfloat162 h;
        *reinterpret_cast<unsigned*>(&h) = wd[k];
        const float2 f = __bfloat1622float2(h);
        a[2 * k] = fmaf(w, f.x, a[2 * k]);
        a[2 * k + 1] = fmaf(w, f.y, a[2 * k + 1]);
      } else {
        a[k] = fmaf(w, __uint_as_float(wd[k]), a[k]);
      }
    }
  }
}

// the vector's elements rounded once to T, as one raw word of VB bytes
template <typename T, int VB>
__device__ __forceinline__ typename Raw<VB>::T pack_vec(const float (&a)[VB / sizeof(T)]) {
  if constexpr (VB == 2) {
    static_assert(sizeof(T) == 2, "a 2-byte vector is one bfloat16");
    return __bfloat16_as_ushort(__float2bfloat16(a[0]));
  } else {
    unsigned wd[VB / 4];
#pragma unroll
    for (int k = 0; k < VB / 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
        wd[k] = *reinterpret_cast<const unsigned*>(&h);
      } else {
        wd[k] = __float_as_uint(a[k]);
      }
    }
    return words_vec(wd);
  }
}
