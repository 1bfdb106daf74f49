// The elementwise kernels' loads and conversions (fused_affine.cu,
// bn_live.cu): fp32 and bf16 to and from fp32, and VEC values of a (rows,
// C) row loaded, unpacked and stored as one 16-byte vector, or as one
// scalar where VEC is 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hdu {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of T as loaded: one 16-byte vector, or one scalar.
template <typename T, int VEC>
struct Packed {
  using type = uint4;
};
template <typename T>
struct Packed<T, 1> {
  using type = T;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Packed<T, VEC>::type load_packed(const T* p) {
  if constexpr (VEC == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Packed<T, VEC>::type& v, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(v);
  } else {
    __align__(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = v;
#pragma unroll
    for (int q = 0; q < VEC; ++q) f[q] = to_float(e[q]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(f[0]);
  } else {
    __align__(16) T e[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) e[q] = from_float<T>(f[q]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  }
}

}  // namespace hdu
