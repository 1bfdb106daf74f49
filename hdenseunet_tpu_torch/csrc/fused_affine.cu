// K1: fused per-channel affine + ReLU, y = relu(x * A + B), for sm_90a.
//
// Replaces hdenseunet_tpu/ops/fused_affine.py:_affine_relu_pallas, the Pallas
// kernel that applies the folded frozen-BN∘Scale affine (fold_bn_scale) and the
// ReLU in front of every encoder conv. The input is a channels-last contiguous
// tensor seen as (rows, C); A and B are per-channel fp32 vectors, which the
// kernel rounds to the tensor's dtype as it reads them, as the JAX function
// casts them (fused_affine.py:103-104).
//
// What bounds it on the H100: device-memory bytes. Each bf16 element is read
// once (2 bytes) and written once (2 bytes); A and B stay in L1/L2. At
// 3.35 TB/s that is the whole cost, so the kernel makes ONE pass: a
// grid-stride loop in which each thread moves 16 bytes (8 bf16 or 4 fp32) with
// one vector load and one vector store, computes in fp32 with one FMA and
// rounds once on store. The plain PyTorch chain (upcast, multiply, add, ReLU,
// downcast) makes several full passes over the same bytes.
//
// A scalar path takes channel counts that are not a multiple of the vector
// width, and pointers that are not 16-byte aligned; the wrapper chooses the
// path and this file checks that the choice is legal.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// v rounded to T and read back as fp32 (a no-op for fp32)
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_float<T>(from_float<T>(v)); }

template <bool RELU>
__device__ __forceinline__ float affine(float x, float a, float b) {
  float y = fmaf(x, a, b);
  if (RELU) y = y < 0.f ? 0.f : y;  // NaN passes through, as torch.relu
  return y;
}

// One 16-byte vector per thread per iteration. c_vec = C / VEC; cv is the
// vector's channel-group index, advanced by the grid stride modulo c_vec so
// the loop does no 64-bit division.
template <typename T, bool RELU>
__global__ void __launch_bounds__(256)
affine_relu_vec(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y,
                long long n_vec, int c_vec) {
  constexpr int VEC = 16 / sizeof(T);
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (i >= n_vec) return;
  int cv = (int)(i % c_vec);
  const int step = (int)(stride % c_vec);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const float4* av = reinterpret_cast<const float4*>(a);
  const float4* bv = reinterpret_cast<const float4*>(b);
  for (; i < n_vec; i += stride) {
    __align__(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = xv[i];
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 aq = __ldg(av + cv * (VEC / 4) + q);
      const float4 bq = __ldg(bv + cv * (VEC / 4) + q);
      e[4 * q + 0] = from_float<T>(
          affine<RELU>(to_float(e[4 * q + 0]), rounded<T>(aq.x), rounded<T>(bq.x)));
      e[4 * q + 1] = from_float<T>(
          affine<RELU>(to_float(e[4 * q + 1]), rounded<T>(aq.y), rounded<T>(bq.y)));
      e[4 * q + 2] = from_float<T>(
          affine<RELU>(to_float(e[4 * q + 2]), rounded<T>(aq.z), rounded<T>(bq.z)));
      e[4 * q + 3] = from_float<T>(
          affine<RELU>(to_float(e[4 * q + 3]), rounded<T>(aq.w), rounded<T>(bq.w)));
    }
    yv[i] = *reinterpret_cast<const uint4*>(e);
    cv += step;
    if (cv >= c_vec) cv -= c_vec;
  }
}

// One element per thread per iteration, for any C and any alignment.
template <typename T, bool RELU>
__global__ void __launch_bounds__(256)
affine_relu_scalar(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, T* __restrict__ y,
                   long long n, int c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (i >= n) return;
  int ch = (int)(i % c);
  const int step = (int)(stride % c);
  for (; i < n; i += stride) {
    y[i] = from_float<T>(
        affine<RELU>(to_float(x[i]), rounded<T>(__ldg(a + ch)), rounded<T>(__ldg(b + ch))));
    ch += step;
    if (ch >= c) ch -= c;
  }
}

constexpr int kThreads = 256;

constexpr int kMaxDevices = 64;

// 16 blocks of 256 threads per SM; each device's SM count is read once.
int max_blocks() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 132 * 16;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev] * 16;
}

template <typename T, bool RELU>
int launch(const void* x, const float* a, const float* b, void* y,
           long long rows, int c, int vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long work = vec ? rows * (c / VEC) : rows * c;
  if (work == 0) return (int)cudaSuccess;
  const long long want = (work + kThreads - 1) / kThreads;
  const int cap = max_blocks();
  const int blocks = (int)(want < cap ? want : cap);
  if (vec) {
    affine_relu_vec<T, RELU><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), a, b, static_cast<T*>(y), work, c / VEC);
  } else {
    affine_relu_scalar<T, RELU><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), a, b, static_cast<T*>(y), work, c);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16-byte vector path, which needs
// C to be a multiple of 16 / sizeof(dtype) and every pointer 16-byte aligned.
extern "C" int hdu_affine_relu(const void* x, const float* a, const float* b,
                               void* y, long long rows, int c, int dtype,
                               int relu, int vec, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (c <= 0 || rows < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (vec && (c % (16 / elem) != 0 || !aligned16(x) || !aligned16(y) ||
              !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return relu ? launch<float, true>(x, a, b, y, rows, c, vec, s)
                : launch<float, false>(x, a, b, y, rows, c, vec, s);
  return relu ? launch<__nv_bfloat16, true>(x, a, b, y, rows, c, vec, s)
              : launch<__nv_bfloat16, false>(x, a, b, y, rows, c, vec, s);
}

extern "C" const char* hdu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
