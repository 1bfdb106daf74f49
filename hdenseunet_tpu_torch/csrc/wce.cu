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
// rows both move tens of MB, some 10-20 us at 3.35 TB/s. One thread takes one
// row at a time in a grid-stride loop. The forward folds each block's sums
// through shared memory in a fixed order into one partial pair per block; a
// second one-block kernel adds the partials in a fixed order (in double) and
// writes (loss, cnt), so the loss is the same bits on every run: no atomics.
// The backward reads g and cnt from device memory, so nothing waits on the host.
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLogClip = -23.025850929940457f;  // ln(1e-10), wce.py:27
constexpr int kMaxClasses = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Row i's fp32 log-softmax into logp[0, c); returns the label, or -1 when it
// lies outside [0, c).
template <typename T>
__device__ __forceinline__ int log_softmax_row(const T* __restrict__ logits,
                                               const int* __restrict__ labels, long long i,
                                               int c, float (&logp)[kMaxClasses]) {
  const T* row = logits + i * c;
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < c) {
      logp[k] = load_float(row + k);
      mx = fmaxf(mx, logp[k]);
    }
  }
  float den = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k)
    if (k < c) den += expf(logp[k] - mx);
  const float lden = logf(den);
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k)
    if (k < c) logp[k] = logp[k] - mx - lden;
  const int y = labels[i];
  return (y >= 0 && y < c) ? y : -1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wce_fwd_partial(const T* __restrict__ logits, const int* __restrict__ labels,
                const float* __restrict__ mask, const float* __restrict__ w,
                float* __restrict__ partial, long long n, int c) {
  __shared__ float red[2][kThreads];
  float s = 0.f, cnt = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float logp[kMaxClasses];
    const int y = log_softmax_row(logits, labels, i, c, logp);
    const float m = mask[i];
    float picked = 0.f, wy = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k)
      if (k == y) {
        picked = logp[k];
        wy = __ldg(w + k);
      }
    s += m * wy * fmaxf(picked, kLogClip);
    cnt += m;
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = cnt;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = red[0][0];
    partial[2 * blockIdx.x + 1] = red[1][0];
  }
}

// One block: out[0] = -s / cnt (the loss), out[1] = cnt.
__global__ void __launch_bounds__(kThreads)
wce_fwd_finish(const float* __restrict__ partial, int blocks, float* __restrict__ out) {
  __shared__ double red[2][kThreads];
  double s = 0.0, cnt = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    s += partial[2 * b];
    cnt += partial[2 * b + 1];
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = cnt;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float sf = (float)red[0][0];
    const float cf = (float)red[1][0];
    out[0] = -sf / cf;
    out[1] = cf;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wce_bwd(const T* __restrict__ logits, const int* __restrict__ labels,
        const float* __restrict__ mask, const float* __restrict__ w,
        const float* __restrict__ cnt_ptr, const float* __restrict__ g_ptr,
        T* __restrict__ dlogits, long long n, int c) {
  const float g = *g_ptr;
  const float cnt = *cnt_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float logp[kMaxClasses];
    const int y = log_softmax_row(logits, labels, i, c, logp);
    float picked = 0.f, wy = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k)
      if (k == y) {
        picked = logp[k];
        wy = __ldg(w + k);
      }
    const float live = picked > kLogClip ? 1.f : 0.f;
    const float coeff = mask[i] * wy * live / cnt;  // wce.py:140
    const float gc = g * coeff;
    T* out = dlogits + i * c;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k)
      if (k < c) store(out + k, gc * (expf(logp[k]) - (k == y ? 1.f : 0.f)));
  }
}

constexpr int kMaxDevices = 64;

// 8 blocks of 256 threads per SM; each device's SM count is read once.
int grid_cap() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 132 * 8;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev] * 8;
}

int fwd_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int cap = grid_cap();
  return want < 1 ? 1 : (int)(want < cap ? want : cap);
}

template <typename T>
int launch_fwd(const void* logits, const int* labels, const float* mask, const float* w,
               float* partial, float* out, long long n, int c, cudaStream_t s) {
  const int blocks = fwd_blocks(n);
  wce_fwd_partial<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, mask,
                                                  w, partial, n, c);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wce_fwd_finish<<<1, kThreads, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const int* labels, const float* mask, const float* w,
               const float* cnt, const float* g, void* dlogits, long long n, int c,
               cudaStream_t s) {
  wce_bwd<T><<<fwd_blocks(n), kThreads, 0, s>>>(static_cast<const T*>(logits), labels, mask,
                                                 w, cnt, g, static_cast<T*>(dlogits), n, c);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 values of scratch that hdu_wce_fwd needs for n rows.
extern "C" long long hdu_wce_fwd_workspace(long long n) { return 2LL * fwd_blocks(n); }

// logits: (N, C) row-major, dtype 0 = float32, 1 = bfloat16, 1 <= C <= 8;
// labels: (N,) int32; mask: (N,) fp32; w: (C,) fp32; partial: workspace of
// hdu_wce_fwd_workspace floats; out: 2 fp32, (loss, cnt).
extern "C" int hdu_wce_fwd(const void* logits, const int* labels, const float* mask,
                           const float* w, float* partial, long long workspace, float* out,
                           long long n, int c, int dtype, void* stream) {
  if (n <= 0 || c < 1 || c > kMaxClasses || (dtype != 0 && dtype != 1) ||
      workspace < 2LL * fwd_blocks(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(logits, labels, mask, w, partial, out, n, c, s);
  return launch_fwd<__nv_bfloat16>(logits, labels, mask, w, partial, out, n, c, s);
}

// cnt: the forward's out[1]; g: the loss's upstream gradient (1 fp32);
// dlogits: (N, C) in the logits' dtype.
extern "C" int hdu_wce_bwd(const void* logits, const int* labels, const float* mask,
                           const float* w, const float* cnt, const float* g, void* dlogits,
                           long long n, int c, int dtype, void* stream) {
  if (n <= 0 || c < 1 || c > kMaxClasses || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(logits, labels, mask, w, cnt, g, dlogits, n, c, s);
  return launch_bwd<__nv_bfloat16>(logits, labels, mask, w, cnt, g, dlogits, n, c, s);
}
