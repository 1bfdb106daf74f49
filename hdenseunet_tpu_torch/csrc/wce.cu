// K2: masked, class-weighted cross-entropy over (N, C <= 8) logits, for sm_90a.
//
// Replaces hdenseunet_tpu/ops/wce.py:_wce_forward_pallas (the Pallas kernel
// of weighted_ce, the loss of every training stage) and its closed-form
// backward _bwd. Per row i, with logits upcast to fp32 and a max-subtracted
// log-softmax (wce.py:38-46):
//     forward   s = sum_i m_i * w[y_i] * max(logp_i[y_i], ln 1e-10),
//               cnt = sum_i m_i,  loss = -s / cnt;
//     backward  dlogits_i = g * (m_i * w[y_i] * live_i / cnt) * (softmax_i - onehot(y_i)),
//               live_i = [logp_i[y_i] > ln 1e-10], cast to the logits' dtype.
// A label outside [0, C) picks nothing, as in the Pallas kernel: it adds its
// mask to cnt and nothing else.
//
// What bounds it: device-memory bytes, and at the training shapes the launch.
// Per row the forward reads C logits, a label and a mask (14 bytes for three
// bf16 logits) and the backward also writes C logits (20 bytes); at N = 3.2 M
// rows that is 13-19 us at 3.35 TB/s. So each direction is one launch, and
// every load and store is 16 bytes wide: a thread takes 8 rows at a time in a
// grid-stride loop, and 8 rows of C logits are C (bf16) or 2C (fp32) whole
// 16-byte vectors, their labels and mask values two vectors each. Rows past
// the last multiple of 8, and arguments that are not 16-byte aligned, go one
// row at a time. The class count is a template argument, so a row's logits
// stay in registers. The forward folds each block's sums in a fixed order
// into one partial pair in the scratch; the last block to arrive (common.cuh)
// adds the partials in a fixed order in double and writes (loss, cnt): the
// same bits on every run, with no float atomics and no second launch. The
// backward reads g and cnt from device memory, so nothing waits on the host.
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kLogClip = -23.025850929940457f;  // ln(1e-10), wce.py:27
constexpr int kMaxClasses = 8;
constexpr int kThreads = 256;
constexpr int kGroup = 8;  // rows per vector step

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A row's fp32 log-softmax, in place.
template <int C>
__device__ __forceinline__ void log_softmax(float (&v)[C]) {
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < C; ++k) mx = fmaxf(mx, v[k]);
  float den = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) den += expf(v[k] - mx);
  const float lden = logf(den);
#pragma unroll
  for (int k = 0; k < C; ++k) v[k] = v[k] - mx - lden;
}

// The label's log-probability and weight; both 0 for a label outside [0, C).
template <int C>
__device__ __forceinline__ void pick(const float (&logp)[C], const float (&w)[C], int y,
                                     float& picked, float& wy) {
  picked = 0.f;
  wy = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == y) {
      picked = logp[k];
      wy = w[k];
    }
}

template <int C>
__device__ __forceinline__ void fwd_row(float (&v)[C], int y, float m, const float (&w)[C],
                                        float& s, float& cnt) {
  log_softmax<C>(v);
  float picked, wy;
  pick<C>(v, w, y, picked, wy);
  s += m * wy * fmaxf(picked, kLogClip);
  cnt += m;
}

// The row's gradient, in place of its logits.
template <int C>
__device__ __forceinline__ void bwd_row(float (&v)[C], int y, float m, const float (&w)[C],
                                        float g, float cnt) {
  log_softmax<C>(v);
  float picked, wy;
  pick<C>(v, w, y, picked, wy);
  const float live = picked > kLogClip ? 1.f : 0.f;
  const float coeff = m * wy * live / cnt;  // wce.py:140
  const float gc = g * coeff;
#pragma unroll
  for (int k = 0; k < C; ++k) v[k] = gc * (expf(v[k]) - (k == y ? 1.f : 0.f));
}

// Group `grp` of 8 rows: logits, labels and mask through 16-byte loads.
template <typename T, int C>
__device__ __forceinline__ void load_group(const T* __restrict__ logits,
                                           const int* __restrict__ labels,
                                           const float* __restrict__ mask, long long grp,
                                           float (&v)[kGroup][C], int (&y)[kGroup],
                                           float (&m)[kGroup]) {
  constexpr int kVecs = kGroup * C * (int)sizeof(T) / 16;
  __align__(16) T e[kGroup * C];
  const uint4* src = reinterpret_cast<const uint4*>(logits) + grp * kVecs;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) reinterpret_cast<uint4*>(e)[k] = __ldg(src + k);
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
#pragma unroll
    for (int k = 0; k < C; ++k) v[j][k] = load_float(e + j * C + k);
  const int4* lp = reinterpret_cast<const int4*>(labels) + 2 * grp;
  const float4* mp = reinterpret_cast<const float4*>(mask) + 2 * grp;
  const int4 l0 = __ldg(lp), l1 = __ldg(lp + 1);
  const float4 m0 = __ldg(mp), m1 = __ldg(mp + 1);
  const int ys[kGroup] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
  const float ms[kGroup] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    y[j] = ys[j];
    m[j] = ms[j];
  }
}

template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ logits, long long i,
                                         float (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) v[k] = load_float(logits + i * C + k);
}

// Sum over the warp in a fixed butterfly order; every lane gets the sum.
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// groups: rows taken 8 at a time (0 without the vector path); the rest of
// the n rows go one at a time. partial: 2 floats per block; out: (loss, cnt).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
wce_fwd(const T* __restrict__ logits, const int* __restrict__ labels,
        const float* __restrict__ mask, const float* __restrict__ w,
        float* __restrict__ partial, unsigned int* __restrict__ counter,
        float* __restrict__ out, long long n, long long groups) {
  float wr[C];
#pragma unroll
  for (int k = 0; k < C; ++k) wr[k] = __ldg(w + k);
  float s = 0.f, cnt = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long grp = t0; grp < groups; grp += stride) {
    float v[kGroup][C], m[kGroup];
    int y[kGroup];
    load_group<T, C>(logits, labels, mask, grp, v, y, m);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) fwd_row<C>(v[j], y[j], m[j], wr, s, cnt);
  }
  for (long long i = groups * kGroup + t0; i < n; i += stride) {
    float v[C];
    load_row<T, C>(logits, i, v);
    fwd_row<C>(v, labels[i], mask[i], wr, s, cnt);
  }

  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ float red[2][kWarps];
  s = warp_sum(s);
  cnt = warp_sum(cnt);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tc = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      ts += red[0][k];
      tc += red[1][k];
    }
    partial[2 * blockIdx.x] = ts;
    partial[2 * blockIdx.x + 1] = tc;
  }
  if (!hdu::arrive_last(counter, gridDim.x)) return;

  // The last block: every block's pair, in double, in a fixed order.
  __shared__ double dred[2][kWarps];
  double ds = 0.0, dc = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    ds += __ldcg(partial + 2 * b);
    dc += __ldcg(partial + 2 * b + 1);
  }
  ds = warp_sum(ds);
  dc = warp_sum(dc);
  if (lane == 0) {
    dred[0][warp] = ds;
    dred[1][warp] = dc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ts = 0.0, tc = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      ts += dred[0][k];
      tc += dred[1][k];
    }
    const float sf = (float)ts;
    const float cf = (float)tc;
    out[0] = -sf / cf;
    out[1] = cf;
    *counter = 0;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
wce_bwd(const T* __restrict__ logits, const int* __restrict__ labels,
        const float* __restrict__ mask, const float* __restrict__ w,
        const float* __restrict__ cnt_ptr, const float* __restrict__ g_ptr,
        T* __restrict__ dlogits, long long n, long long groups) {
  const float g = *g_ptr;
  const float cnt = *cnt_ptr;
  float wr[C];
#pragma unroll
  for (int k = 0; k < C; ++k) wr[k] = __ldg(w + k);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long grp = t0; grp < groups; grp += stride) {
    float v[kGroup][C], m[kGroup];
    int y[kGroup];
    load_group<T, C>(logits, labels, mask, grp, v, y, m);
    constexpr int kVecs = kGroup * C * (int)sizeof(T) / 16;
    __align__(16) T e[kGroup * C];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      bwd_row<C>(v[j], y[j], m[j], wr, g, cnt);
#pragma unroll
      for (int k = 0; k < C; ++k) store(e + j * C + k, v[j][k]);
    }
    uint4* dst = reinterpret_cast<uint4*>(dlogits) + grp * kVecs;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) dst[k] = reinterpret_cast<const uint4*>(e)[k];
  }
  for (long long i = groups * kGroup + t0; i < n; i += stride) {
    float v[C];
    load_row<T, C>(logits, i, v);
    bwd_row<C>(v, labels[i], mask[i], wr, g, cnt);
#pragma unroll
    for (int k = 0; k < C; ++k) store(dlogits + i * C + k, v[k]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Blocks per SM that `kernel` can keep resident.
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return n > 0 ? n : 1;
}

// Blocks for `work` threads' worth of steps, at most one resident wave.
int grid(long long work, int per_sm) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)hdu::sm_count() * per_sm;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

// f(std::integral_constant<int, C>{}) for the class count c in [1, kMaxClasses].
template <typename F>
int with_classes(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fwd(const void* logits, const int* labels, const float* mask, const float* w,
               float* out, long long n, int c, long long groups, void* scratch, cudaStream_t s) {
  return with_classes(c, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    static const int per_sm = blocks_per_sm(wce_fwd<T, C>);
    const int blocks = grid(groups > 0 ? groups : n, per_sm);
    if (2LL * blocks > hdu::kPartialFloats) return (int)cudaErrorInvalidValue;
    wce_fwd<T, C><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, mask, w,
                                              hdu::partials(scratch), hdu::counters(scratch),
                                              out, n, groups);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_bwd(const void* logits, const int* labels, const float* mask, const float* w,
               const float* cnt, const float* g, void* dlogits, long long n, int c,
               long long groups, cudaStream_t s) {
  return with_classes(c, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    static const int per_sm = blocks_per_sm(wce_bwd<T, C>);
    const int blocks = grid(groups > 0 ? groups : n, per_sm);
    wce_bwd<T, C><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, mask, w,
                                              cnt, g, static_cast<T*>(dlogits), n, groups);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// logits: (N, C) row-major, dtype 0 = float32, 1 = bfloat16, 1 <= C <= 8;
// labels: (N,) int32; mask: (N,) fp32; w: (C,) fp32; out: 2 fp32, (loss,
// cnt); scratch: hdu_scratch_bytes() bytes of the calling stream
// (common.cuh). Rows go 8 at a time when logits, labels and mask are 16-byte
// aligned. One kernel launch.
extern "C" int hdu_wce_fwd(const void* logits, const int* labels, const float* mask,
                           const float* w, float* out, long long n, int c, int dtype,
                           void* scratch, void* stream) {
  if (n <= 0 || c < 1 || c > kMaxClasses || (dtype != 0 && dtype != 1) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(logits) && aligned16(labels) && aligned16(mask);
  const long long groups = vec ? n / kGroup : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(logits, labels, mask, w, out, n, c, groups, scratch, s);
  return launch_fwd<__nv_bfloat16>(logits, labels, mask, w, out, n, c, groups, scratch, s);
}

// cnt: the forward's out[1]; g: the loss's upstream gradient (1 fp32);
// dlogits: (N, C) in the logits' dtype. Rows go 8 at a time when logits,
// labels, mask and dlogits are 16-byte aligned. One kernel launch.
extern "C" int hdu_wce_bwd(const void* logits, const int* labels, const float* mask,
                           const float* w, const float* cnt, const float* g, void* dlogits,
                           long long n, int c, int dtype, void* stream) {
  if (n <= 0 || c < 1 || c > kMaxClasses || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(logits) && aligned16(labels) && aligned16(mask) && aligned16(dlogits);
  const long long groups = vec ? n / kGroup : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(logits, labels, mask, w, cnt, g, dlogits, n, c, groups, s);
  return launch_bwd<__nv_bfloat16>(logits, labels, mask, w, cnt, g, dlogits, n, c, groups, s);
}
