// K7: a training step's inverted dropout, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves dropout to XLA, which fuses
// its hash. In PyTorch the same rule (models/layers.dropout) was an int64
// arange over every element hashed in place, some twenty int64 passes, then
// a compare, a cast and the bf16 passes x / keep * mask, with the mask kept
// for the backward.
//
// The rule, per element i of x's memory (ops/dropout.py states it):
//   h = lowbias32((offset + i) ^ seed), keep the element when h >> 8 <
//   threshold (= round(keep * 2^24)), and scale a kept one by inv = 1 / keep.
// Forward and backward are the same operation on x and on g, so one kernel
// serves both and the mask is recomputed, never stored. The seed is read on
// the device (a 0-d int64 tensor, its low 32 bits), so a captured step draws
// a new mask on every replay.
//
// Rounding, as the ATen chain on the card: a kept element is x * inv in fp32
// rounded once to x's dtype; a dropped one is a zero with the sign of x, or
// NaN where the chain's product with the 0/1 mask gives NaN: the forward
// multiplies the rounded x * inv by 0 (scale_first), the backward g by 0
// before scaling.
//
// What bounds it on the H100: device-memory bytes, 2 + 2 B an element in
// bf16. Each thread loads 16-byte vectors (8 bf16 or 4 fp32), two in flight
// a step of a grid-stride loop over a grid the size of the card's resident
// blocks; the hash is ten integer operations an element. A scalar pass
// takes the tail past the last whole vector, and the whole tensor when x or
// y is not 16-byte aligned.
//
// Each launch goes on the caller's stream and allocates nothing; it returns
// cudaGetLastError() and the Python wrapper (ops/dropout.py) raises on a
// non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "vec.cuh"

namespace {

using namespace hdu;

constexpr int kThreads = 256;

// The lowbias32-style mixer of models/layers.hash32, in uint32 arithmetic.
__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7FEB352Du;
  v ^= v >> 15;
  v *= 0x6A09E667u;
  return v ^ (v >> 16);
}

struct Rule {
  uint32_t seed, offset, threshold;
  float inv;
  bool scale_first;
};

// Element e of x's memory, its value v, through the rule, as fp32 that is
// exact in T.
template <typename T>
__device__ __forceinline__ float drop(float v, long long e, const Rule& r) {
  const bool kept = (mix32((r.offset + static_cast<uint32_t>(e)) ^ r.seed) >> 8) < r.threshold;
  const float y = to_float(from_float<T>(__fmul_rn(v, r.inv)));
  return kept ? y : (r.scale_first ? y : v) * 0.0f;
}

template <typename T, int VEC>
__device__ __forceinline__ void drop_vec(const typename Packed<T, VEC>::type& in, T* out, long long e,
                                         const Rule& r) {
  float f[VEC];
  unpack<T, VEC>(in, f);
#pragma unroll
  for (int q = 0; q < VEC; ++q) f[q] = drop<T>(f[q], e + q, r);
  store_vec<T, VEC>(out, f);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dropout_apply(const T* __restrict__ x, T* __restrict__ y, long long n, const long long* __restrict__ seed,
              uint32_t offset, uint32_t threshold, float inv, int scale_first) {
  const Rule r{static_cast<uint32_t>(__ldg(seed)), offset, threshold, inv, scale_first != 0};
  const long long vecs = n / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long v = first;
  for (; v + stride < vecs; v += 2 * stride) {
    const auto a = load_packed<T, VEC>(x + v * VEC);
    const auto b = load_packed<T, VEC>(x + (v + stride) * VEC);
    drop_vec<T, VEC>(a, y + v * VEC, v * VEC, r);
    drop_vec<T, VEC>(b, y + (v + stride) * VEC, (v + stride) * VEC, r);
  }
  if (v < vecs) drop_vec<T, VEC>(load_packed<T, VEC>(x + v * VEC), y + v * VEC, v * VEC, r);
  for (long long e = vecs * VEC + first; e < n; e += stride)
    y[e] = from_float<T>(drop<T>(to_float(x[e]), e, r));
}

// The resident blocks of the whole card, or fewer where the vectors do not
// fill them; at least one, for a tail alone.
template <typename T, int VEC>
int grid_size(long long n) {
  static int per_sm = 0;
  if (per_sm == 0) {
    int found = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&found, dropout_apply<T, VEC>, kThreads, 0);
    per_sm = found > 0 ? found : 1;
  }
  const long long need = (n / VEC + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm) * sm_count();
  return static_cast<int>(need < 1 ? 1 : need < most ? need : most);
}

template <typename T, int VEC>
int launch(const void* x, void* y, long long n, const long long* seed, uint32_t offset,
           uint32_t threshold, float inv, int scale_first, cudaStream_t stream) {
  dropout_apply<T, VEC><<<grid_size<T, VEC>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, offset, threshold, inv, scale_first);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, y: n elements of one dtype (0 = float32, 1 = bfloat16), each read and
// written in memory order. seed: a 0-d int64 on the device, its
// low 32 bits taken. Element e is kept when mix32((offset + e) ^ seed) >> 8
// < threshold (offset + n <= 2^32, threshold <= 2^24); a kept one becomes
// x * inv, a dropped one 0 (scale_first: the forward's rounding of a dropped
// element, see the top of this file). The 16-byte path runs when x and y
// are 16-byte aligned, the scalar path otherwise.
extern "C" int hdu_dropout(const void* x, void* y, long long n, const long long* seed,
                           unsigned int offset, unsigned int threshold, float inv, int scale_first,
                           int dtype, void* stream) {
  if (n < 0 || seed == nullptr || (dtype != 0 && dtype != 1) || threshold > (1u << 24) ||
      static_cast<unsigned long long>(offset) + static_cast<unsigned long long>(n) > (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y);
  if (dtype == 0)
    return vec ? launch<float, 4>(x, y, n, seed, offset, threshold, inv, scale_first, s)
               : launch<float, 1>(x, y, n, seed, offset, threshold, inv, scale_first, s);
  return vec ? launch<__nv_bfloat16, 8>(x, y, n, seed, offset, threshold, inv, scale_first, s)
             : launch<__nv_bfloat16, 1>(x, y, n, seed, offset, threshold, inv, scale_first, s);
}
