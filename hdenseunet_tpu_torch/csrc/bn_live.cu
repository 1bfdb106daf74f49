// K6: the live-statistics BatchNorm∘[Scale]∘[ReLU] of a training forward,
// and its backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves a training step's live BN
// (layers.py:142-222) to XLA, which fuses it. In PyTorch the same chain
// (torch.var_mean over a float32 copy of x, the BN and Scale affines as
// broadcast passes in x's dtype, the ReLU, then autograd's float32 passes
// and its reductions of the broadcast gradients) is some fifteen launches
// forward and twenty-five backward at every live site.
//
// x is a channels-last contiguous tensor seen as (rows, C), bf16 or fp32;
// the BN and Scale parameters are fp32 (C,) vectors.
//
// Forward, two launches (hdu_bn_live_forward):
//   bn_live_stats reads x once. Each thread keeps Welford's (count, mean,
//     M2) in fp32 for its channels over its rows; the block folds its
//     threads' into one partial a channel, and the grid's last block to
//     arrive (common.cuh's ticket) folds the partials in double, in a fixed
//     order, with no float atomics, so a replay repeats bit for bit. It
//     writes the batch mean and biased variance and the fold of the BN, the
//     Scale and eps into one (A, B) a channel: A = inv * gamma_bn [*
//     gamma_s], B = (beta_bn - mean * inv * gamma_bn) [* gamma_s + beta_s],
//     inv = 1 / sqrt(var + eps).
//   bn_live_apply: y = [relu](x * A + B) in fp32, rounded once to x's dtype.
// Backward, two launches (hdu_bn_live_backward), given g and the saved x,
// mean, inv, A and B (the ReLU mask is recomputed from x):
//   bn_live_bwd_reduce reads g and x once for S1 = sum g' and S2 = sum g' *
//     xh, g' = g * [x * A + B > 0], xh = (x - mean) * inv, fp32 in each
//     thread, double across threads and blocks, in a fixed order; its last
//     block writes the parameters' gradients (dgamma_bn = gamma_s * S2,
//     dbeta_bn = gamma_s * S1, dgamma_s = gamma_bn * S2 + beta_bn * S1,
//     dbeta_s = S1) and dx's coefficients;
//   bn_live_bwd_apply: dx = c1 * g' + c0 + c2 * (x - mean), c1 = gamma_bn *
//     gamma_s * inv, c0 = -c1 * S1 / N, c2 = -c1 * S2 * inv / N: the
//     gradient through the batch statistics included.
//
// What bounds it on the H100: device-memory bytes. In bf16 the forward
// reads x twice and writes y (6 B an element), the backward reads g and x
// twice and writes dx (10 B). Every kernel gives each thread one fixed
// group of channels (8 bf16 or 4 fp32, one 16-byte vector, held with its
// per-channel coefficients in registers) and walks its rows with four rows'
// loads in flight; the grid is (row blocks, channel tiles of at most 32
// groups), one or two blocks of 512 threads an SM in all. A scalar path
// takes a C that is not a multiple of the vector width, or an unaligned
// pointer.
//
// On a mesh of several ranks the batch statistics and S1/S2 are the global
// batch's, so each entry point runs in two phases with a merge across ranks
// between them (ops/bn_live.py): phase 1 is the reduction alone, which
// writes this rank's per-channel sums in double, unrounded; phase 2 takes
// the merged sums and finishes with one small launch (bn_live_coef,
// bn_live_bwd_coef) and the apply kernel. Phase 0, one rank, is both in one
// call: the reduction's last block finishes itself, two launches a
// direction. The finish is one device function either way, so phase 1 then
// phase 2 on unmerged sums gives phase 0's bits.
//
// Each launch goes on the caller's stream and allocates nothing: the
// partials and tickets live in the caller's per-stream scratch
// (common.cuh); it returns cudaGetLastError() and the Python wrapper
// (ops/bn_live.py) raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "vec.cuh"

namespace {

using namespace hdu;

// x * a + b with two roundings, as the plain version's multiply and add
// (no contraction into an FMA), so the ReLU mask the backward recomputes
// is the forward's and the plain version's.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

constexpr int kThreads = 512;
constexpr int kMaxVec = 8;
constexpr int kRowUnroll = 4;
constexpr int kMaxWidth = 32 * kMaxVec;  // channels of a tile

// Per column k in [0, cols): the sums over items t in [0, items) of the
// pair term(k, t, load(k, t)), in double and in one fixed order. Slice s of
// a column's threads adds t = s, s + slices, ..., eight loads at a time
// (the last eight guarded), all in flight before it adds; the slices then
// fold in order through `fold` (2 * kThreads doubles of shared memory),
// and one thread a column calls put(k, sum of firsts, sum of seconds).
// Every thread of the block calls it; cols <= the block's threads.
template <typename Load, typename Term, typename Put>
__device__ __forceinline__ void column_sums(int cols, int items, double* fold, Load load,
                                            Term term, Put put) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int slices = nt / cols;
  const int k = tid % cols, s = tid / cols;
  if (s < slices) {
    double a = 0.0, b = 0.0;
    for (int t = s; t < items; t += 8 * slices) {
      float2 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ti = t + i * slices;
        v[i] = ti < items ? load(k, ti) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ti = t + i * slices;
        if (ti < items) {
          const double2 d = term(k, ti, v[i]);
          a += d.x;
          b += d.y;
        }
      }
    }
    fold[s * cols + k] = a;
    fold[nt + s * cols + k] = b;
  }
  __syncthreads();
  if (tid < cols) {
    double a = 0.0, b = 0.0;
    for (int i = 0; i < slices; ++i) {
      a += fold[i * cols + tid];
      b += fold[nt + i * cols + tid];
    }
    put(tid, a, b);
  }
}

// A pair of partials as column_sums adds them.
__device__ __forceinline__ double2 widen(float2 v) {
  return make_double2((double)v.x, (double)v.y);
}

// Channel ch's batch mean and biased variance (var may be a rounding below
// zero) -> mean, var (C,) and coef (3, C): inv, A, B, fp32, each product
// and sum rounded once, as the plain version's.
__device__ __forceinline__ void finish_stats(int ch, int c, double mean, double var, float eps,
                                             const float* gamma_bn, const float* beta_bn,
                                             const float* gamma_s, const float* beta_s,
                                             float* mean_out, float* var_out, float* coef) {
  const float mu = (float)mean;
  const float v = var > 0.0 ? (float)var : 0.f;
  const float inv = (float)(1.0 / sqrt((double)__fadd_rn(v, eps)));
  float a = __fmul_rn(inv, gamma_bn[ch]);
  float b = __fsub_rn(beta_bn[ch], __fmul_rn(mu, a));
  if (gamma_s != nullptr) {
    b = __fadd_rn(__fmul_rn(b, gamma_s[ch]), beta_s[ch]);
    a = __fmul_rn(a, gamma_s[ch]);
  }
  mean_out[ch] = mu;
  var_out[ch] = v;
  coef[ch] = inv;
  coef[c + ch] = a;
  coef[2 * c + ch] = b;
}

// Channel ch's gradients from this rank's sums (s1, s2) and dx's
// coefficients from the global batch's (S1, S2 over n rows): grads (4, C)
// dgamma_bn, dbeta_bn, dgamma_s, dbeta_s (the last two zero without a
// Scale); dcoef (3, C) c1, c0, c2. On one rank the two pairs are one.
__device__ __forceinline__ void finish_grads(int ch, int c, double s1, double s2, double S1,
                                             double S2, double n, const float* coef,
                                             const float* gamma_bn, const float* beta_bn,
                                             const float* gamma_s, float* grads, float* dcoef) {
  const double gb = gamma_bn[ch];
  const double gs = gamma_s != nullptr ? (double)gamma_s[ch] : 1.0;
  grads[ch] = (float)(gs * s2);
  grads[c + ch] = (float)(gs * s1);
  grads[2 * c + ch] =
      gamma_s != nullptr ? (float)__dadd_rn(__dmul_rn(gb, s2), __dmul_rn((double)beta_bn[ch], s1)) : 0.f;
  grads[3 * c + ch] = gamma_s != nullptr ? (float)s1 : 0.f;
  const double iv = coef[ch];
  const double c1 = gb * gs * iv;
  dcoef[ch] = (float)c1;
  dcoef[c + ch] = (float)(-c1 * S1 / n);
  dcoef[2 * c + ch] = (float)(-c1 * S2 * iv / n);
}

// ---------------------------------------------------------------------------
// Forward statistics. Block (tx, ty) of grid (row blocks, tiles); the tile's
// partials in the scratch: (gridDim.x, 2, width) fp32, each block's mean
// then M2 over its rows; counters[blockIdx.y] is the tile's ticket.
// Outputs, (C,) fp32 each: mean, var (biased), and coef (3, C): inv, A, B;
// or, given `moments` (phase 1), the mean and variance in double there, (2,
// C), unfinished.
// ---------------------------------------------------------------------------
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
bn_live_stats(const T* __restrict__ x, const float* __restrict__ gamma_bn,
              const float* __restrict__ beta_bn, const float* __restrict__ gamma_s,
              const float* __restrict__ beta_s, float eps, float* __restrict__ partial,
              unsigned int* __restrict__ counters, float* __restrict__ mean_out,
              float* __restrict__ var_out, float* __restrict__ coef,
              double* __restrict__ moments, long long rows, int c, long long rows_per_block) {
  using P = typename Packed<T, VEC>::type;
  __shared__ __align__(16) float red[2][kThreads * kMaxVec];
  __shared__ double fold[2 * kThreads];
  __shared__ float shift[kMaxWidth];
  const int groups = c / VEC;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = cg < groups;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) mean[q] = m2[q] = 0.f;
  if (active) {
    const int step = blockDim.y;
    const long long col = (long long)cg * VEC;
    float n = 0.f;
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowUnroll * step) {
      P xr[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
        if (r + u * step < r1) xr[u] = load_packed<T, VEC>(x + (r + u * step) * c + col);
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r + u * step < r1) {
          float xv[VEC];
          unpack<T, VEC>(xr[u], xv);
          n += 1.f;
          const float rn = __frcp_rn(n);  // one reciprocal for the row's VEC channels
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const float d = xv[q] - mean[q];
            mean[q] = fmaf(d, rn, mean[q]);
            m2[q] = fmaf(d, xv[q] - mean[q], m2[q]);
          }
        }
      }
    }
  }

  // The block's threads, folded per column (Chan's formula about thread row
  // 0's mean: sums of n_t * d and M2_t + n_t * d^2, d = mean_t - shift).
  const int width = blockDim.x * VEC;
  const int cols = 2 * width;
  const int lane = threadIdx.x * VEC;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    red[0][threadIdx.y * width + lane + q] = mean[q];
    red[1][threadIdx.y * width + lane + q] = m2[q];
  }
  __syncthreads();
  float* tile = partial + (long long)blockIdx.y * gridDim.x * cols;
  const int len = (int)(r1 - r0);  // thread row t visited len / ty rows, one more if t < len % ty
  const int base = len / (int)blockDim.y, extra = len % (int)blockDim.y;
  column_sums(
      width, blockDim.y, fold,
      [&](int k, int t) { return make_float2(red[0][t * width + k], red[1][t * width + k]); },
      [&](int k, int t, float2 v) {
        const double nt = base + (t < extra);
        const double d = (double)v.x - (double)red[0][k];
        return make_double2(nt * d, nt > 0 ? (double)v.y + nt * d * d : 0.0);
      },
      [&](int k, double s, double q) {
        float* out = tile + (long long)blockIdx.x * cols;
        out[k] = (float)((double)red[0][k] + s / len);
        out[width + k] = (float)(q - s * s / len);
      });
  if (!hdu::arrive_last(counters + blockIdx.y, gridDim.x)) return;

  // The tile's last block: every block's partial, in double, in block
  // order, about block 0's mean.
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < width) shift[tid] = __ldcg(tile + tid);
  __syncthreads();
  column_sums(
      width, gridDim.x, fold,
      [&](int k, int b) {
        const float* in = tile + (long long)b * cols;
        return make_float2(__ldcg(in + k), __ldcg(in + width + k));
      },
      [&](int k, int b, float2 v) {
        const long long rb = (long long)b * rows_per_block;
        const double nb = (double)(rows - rb < rows_per_block ? rows - rb : rows_per_block);
        const double d = (double)v.x - (double)shift[k];
        return make_double2(nb * d, (double)v.y + nb * d * d);
      },
      [&](int k, double s, double q) {
        const int ch = blockIdx.y * width + k;
        if (ch >= c) return;
        const double n = (double)rows;
        const double mu = (double)shift[k] + s / n;
        const double v = (q - s * s / n) / n;
        if (moments != nullptr) {
          moments[ch] = mu;
          moments[c + ch] = v;
        } else {
          finish_stats(ch, c, mu, v, eps, gamma_bn, beta_bn, gamma_s, beta_s, mean_out, var_out,
                       coef);
        }
      });
  if (tid == 0) counters[blockIdx.y] = 0;
}

// Phase 2 of the statistics: finish_stats of merged (2C + 1) doubles, the
// global batch's mean and variance (the row count after them is unread).
__global__ void bn_live_coef(const double* __restrict__ merged, const float* __restrict__ gamma_bn,
                             const float* __restrict__ beta_bn, const float* __restrict__ gamma_s,
                             const float* __restrict__ beta_s, float eps,
                             float* __restrict__ mean_out, float* __restrict__ var_out,
                             float* __restrict__ coef, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch < c)
    finish_stats(ch, c, merged[ch], merged[c + ch], eps, gamma_bn, beta_bn, gamma_s, beta_s,
                 mean_out, var_out, coef);
}

// y = [relu](x * A + B), coef (3, C): inv, A, B.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
bn_live_apply(const T* __restrict__ x, const float* __restrict__ coef, T* __restrict__ y,
              long long rows, int c, long long rows_per_block) {
  using P = typename Packed<T, VEC>::type;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  if (cg >= c / VEC) return;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long col = (long long)cg * VEC;
  float a[VEC], b[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    a[q] = __ldg(coef + c + col + q);
    b[q] = __ldg(coef + 2 * c + col + q);
  }
  const int step = blockDim.y;
  for (long long r = r0 + threadIdx.y; r < r1; r += kRowUnroll * step) {
    P xr[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
      if (r + u * step < r1) xr[u] = load_packed<T, VEC>(x + (r + u * step) * c + col);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (r + u * step < r1) {
        float v[VEC];
        unpack<T, VEC>(xr[u], v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          v[q] = affine(v[q], a[q], b[q]);
          if (RELU) v[q] = v[q] < 0.f ? 0.f : v[q];  // NaN passes through, as torch.relu
        }
        store_vec<T, VEC>(y + (r + u * step) * c + col, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward reduction: S1, S2 a channel, then the gradients and dx's
// coefficients. Partials as the statistics' (S1 then S2 sums of a block).
// Outputs: grads (4, C): dgamma_bn, dbeta_bn, dgamma_s, dbeta_s (the last
// two zero without a Scale); dcoef (3, C): c1, c0, c2; or, given `sums`
// (phase 1), S1 and S2 in double there, (2, C), unfinished.
// ---------------------------------------------------------------------------
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
bn_live_bwd_reduce(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ coef,
                   const float* __restrict__ gamma_bn, const float* __restrict__ beta_bn,
                   const float* __restrict__ gamma_s, float* __restrict__ partial,
                   unsigned int* __restrict__ counters, float* __restrict__ grads,
                   float* __restrict__ dcoef, double* __restrict__ sums, long long rows, int c,
                   long long rows_per_block) {
  using P = typename Packed<T, VEC>::type;
  __shared__ __align__(16) float red[2][kThreads * kMaxVec];
  __shared__ double fold[2 * kThreads];
  const int groups = c / VEC;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = cg < groups;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long col = (long long)cg * VEC;
  float s1[VEC], s2[VEC], mu[VEC], inv[VEC];
  [[maybe_unused]] float a[VEC], b[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    s1[q] = s2[q] = 0.f;
    mu[q] = active ? __ldg(mean + col + q) : 0.f;
    inv[q] = active ? __ldg(coef + col + q) : 0.f;
    if constexpr (RELU) {
      a[q] = active ? __ldg(coef + c + col + q) : 0.f;
      b[q] = active ? __ldg(coef + 2 * c + col + q) : 0.f;
    }
  }
  if (active) {
    const int step = blockDim.y;
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowUnroll * step) {
      P gr[kRowUnroll], xr[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r + u * step < r1) {
          const long long off = (r + u * step) * c + col;
          gr[u] = load_packed<T, VEC>(g + off);
          xr[u] = load_packed<T, VEC>(x + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r + u * step < r1) {
          float gv[VEC], xv[VEC];
          unpack<T, VEC>(gr[u], gv);
          unpack<T, VEC>(xr[u], xv);
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            if constexpr (RELU) {
              if (!(affine(xv[q], a[q], b[q]) > 0.f)) gv[q] = 0.f;
            }
            const float xh = __fmul_rn(__fsub_rn(xv[q], mu[q]), inv[q]);
            s1[q] += gv[q];
            s2[q] = fmaf(gv[q], xh, s2[q]);
          }
        }
      }
    }
  }

  const int width = blockDim.x * VEC;
  const int cols = 2 * width;
  const int lane = threadIdx.x * VEC;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    red[0][threadIdx.y * width + lane + q] = s1[q];
    red[1][threadIdx.y * width + lane + q] = s2[q];
  }
  __syncthreads();
  float* tile = partial + (long long)blockIdx.y * gridDim.x * cols;
  column_sums(
      width, blockDim.y, fold,
      [&](int k, int t) { return make_float2(red[0][t * width + k], red[1][t * width + k]); },
      [](int, int, float2 v) { return widen(v); },
      [&](int k, double s, double q) {
        float* out = tile + (long long)blockIdx.x * cols;
        out[k] = (float)s;
        out[width + k] = (float)q;
      });
  if (!hdu::arrive_last(counters + blockIdx.y, gridDim.x)) return;

  column_sums(
      width, gridDim.x, fold,
      [&](int k, int bk) {
        const float* in = tile + (long long)bk * cols;
        return make_float2(__ldcg(in + k), __ldcg(in + width + k));
      },
      [](int, int, float2 v) { return widen(v); },
      [&](int k, double S1, double S2) {
        const int ch = blockIdx.y * width + k;
        if (ch >= c) return;
        if (sums != nullptr) {
          sums[ch] = S1;
          sums[c + ch] = S2;
        } else {
          finish_grads(ch, c, S1, S2, S1, S2, (double)rows, coef, gamma_bn, beta_bn, gamma_s, grads,
                       dcoef);
        }
      });
  if (threadIdx.x == 0 && threadIdx.y == 0) counters[blockIdx.y] = 0;
}

// Phase 2 of the backward reduction: finish_grads of this rank's sums (2,
// C) and the merged (2C + 1) doubles, the global S1, S2 and row count.
__global__ void bn_live_bwd_coef(const double* __restrict__ sums, const double* __restrict__ merged,
                                 const float* __restrict__ coef, const float* __restrict__ gamma_bn,
                                 const float* __restrict__ beta_bn,
                                 const float* __restrict__ gamma_s, float* __restrict__ grads,
                                 float* __restrict__ dcoef, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch < c)
    finish_grads(ch, c, sums[ch], sums[c + ch], merged[ch], merged[c + ch], merged[2 * c], coef,
                 gamma_bn, beta_bn, gamma_s, grads, dcoef);
}

// dx = c1 * g' + c0 + c2 * (x - mean).
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
bn_live_bwd_apply(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ coef,
                  const float* __restrict__ dcoef, T* __restrict__ dx, long long rows, int c,
                  long long rows_per_block) {
  using P = typename Packed<T, VEC>::type;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  if (cg >= c / VEC) return;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long col = (long long)cg * VEC;
  float mu[VEC], c1[VEC], c0[VEC], c2[VEC];
  [[maybe_unused]] float a[VEC], b[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    mu[q] = __ldg(mean + col + q);
    c1[q] = __ldg(dcoef + col + q);
    c0[q] = __ldg(dcoef + c + col + q);
    c2[q] = __ldg(dcoef + 2 * c + col + q);
    if constexpr (RELU) {
      a[q] = __ldg(coef + c + col + q);
      b[q] = __ldg(coef + 2 * c + col + q);
    }
  }
  const int step = blockDim.y;
  for (long long r = r0 + threadIdx.y; r < r1; r += kRowUnroll * step) {
    P gr[kRowUnroll], xr[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (r + u * step < r1) {
        const long long off = (r + u * step) * c + col;
        gr[u] = load_packed<T, VEC>(g + off);
        xr[u] = load_packed<T, VEC>(x + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (r + u * step < r1) {
        float gv[VEC], xv[VEC], d[VEC];
        unpack<T, VEC>(gr[u], gv);
        unpack<T, VEC>(xr[u], xv);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          if constexpr (RELU) {
            if (!(affine(xv[q], a[q], b[q]) > 0.f)) gv[q] = 0.f;
          }
          d[q] = fmaf(c2[q], __fsub_rn(xv[q], mu[q]), fmaf(c1[q], gv[q], c0[q]));
        }
        store_vec<T, VEC>(dx + (r + u * step) * c + col, d);
      }
    }
  }
}

struct Geometry {
  int tx, ty, tiles, blocks;
  long long rows_per_block;
};

// Channel tiles of at most 32 groups of `vec` channels, as even as the
// count allows, across threadIdx.x; rows across threadIdx.y; about
// `per_sm` blocks an SM in all, each a whole number of unrolled row steps;
// with `partials` floats a channel a block, no more blocks than the
// scratch holds.
Geometry geometry(long long rows, int c, int vec, int per_sm, int partials) {
  Geometry geo;
  const int groups = c / vec;
  geo.tiles = (groups + 31) / 32;
  geo.tx = (groups + geo.tiles - 1) / geo.tiles;
  geo.ty = kThreads / geo.tx;
  const long long per_step = (long long)geo.ty * kRowUnroll;
  long long blocks = (long long)hdu::sm_count() * per_sm / geo.tiles;
  const long long most = (rows + per_step - 1) / per_step;
  if (blocks > most) blocks = most;
  if (partials > 0) {
    const long long fit =
        hdu::kPartialFloats / ((long long)geo.tiles * partials * geo.tx * vec);
    if (blocks > fit) blocks = fit;
  }
  if (blocks < 1) blocks = 1;
  const long long even = (rows + blocks - 1) / blocks;
  geo.rows_per_block = (even + per_step - 1) / per_step * per_step;
  geo.blocks = (int)((rows + geo.rows_per_block - 1) / geo.rows_per_block);
  return geo;
}

bool fits(const Geometry& geo, int vec) {
  return geo.tiles <= hdu::kTicketSlots &&
         (long long)geo.tiles * geo.blocks * 2 * geo.tx * vec <= hdu::kPartialFloats;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

constexpr int kCoefThreads = 256;

// The forward's arguments, as hdu_bn_live_forward takes them.
struct Fwd {
  const void* x;
  const float *gamma_bn, *beta_bn, *gamma_s, *beta_s;
  float eps;
  void* y;
  float *mean, *var, *coef;
  double* moments;
  long long rows;
  int c;
  void* scratch;
  cudaStream_t stream;
};

template <typename T, int VEC>
int forward(int phase, int relu, const Fwd& a) {
  if (phase == 2) {
    bn_live_coef<<<(a.c + kCoefThreads - 1) / kCoefThreads, kCoefThreads, 0, a.stream>>>(
        a.moments, a.gamma_bn, a.beta_bn, a.gamma_s, a.beta_s, a.eps, a.mean, a.var, a.coef, a.c);
  } else {
    const Geometry st = geometry(a.rows, a.c, VEC, 2, 2);
    if (!fits(st, VEC)) return (int)cudaErrorInvalidValue;
    bn_live_stats<T, VEC><<<dim3(st.blocks, st.tiles), dim3(st.tx, st.ty), 0, a.stream>>>(
        static_cast<const T*>(a.x), a.gamma_bn, a.beta_bn, a.gamma_s, a.beta_s, a.eps,
        hdu::partials(a.scratch), hdu::counters(a.scratch), a.mean, a.var, a.coef,
        phase == 1 ? a.moments : nullptr, a.rows, a.c, st.rows_per_block);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || phase == 1) return rc;
  const Geometry ap = geometry(a.rows, a.c, VEC, 2, 0);
  const dim3 grid(ap.blocks, ap.tiles), block(ap.tx, ap.ty);
  if (relu)
    bn_live_apply<T, VEC, true><<<grid, block, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.coef, static_cast<T*>(a.y), a.rows, a.c, ap.rows_per_block);
  else
    bn_live_apply<T, VEC, false><<<grid, block, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.coef, static_cast<T*>(a.y), a.rows, a.c, ap.rows_per_block);
  return (int)cudaGetLastError();
}

// The backward's arguments, as hdu_bn_live_backward takes them.
struct Bwd {
  const void *g, *x;
  const float *mean, *coef, *gamma_bn, *beta_bn, *gamma_s;
  void* dx;
  float *grads, *dcoef;
  double* sums;
  const double* merged;
  long long rows;
  int c;
  void* scratch;
  cudaStream_t stream;
};

template <typename T, int VEC, bool RELU>
int backward(int phase, const Bwd& a) {
  if (phase == 2) {
    bn_live_bwd_coef<<<(a.c + kCoefThreads - 1) / kCoefThreads, kCoefThreads, 0, a.stream>>>(
        a.sums, a.merged, a.coef, a.gamma_bn, a.beta_bn, a.gamma_s, a.grads, a.dcoef, a.c);
  } else {
    const Geometry rd = geometry(a.rows, a.c, VEC, 1, 2);
    if (!fits(rd, VEC)) return (int)cudaErrorInvalidValue;
    bn_live_bwd_reduce<T, VEC, RELU><<<dim3(rd.blocks, rd.tiles), dim3(rd.tx, rd.ty), 0, a.stream>>>(
        static_cast<const T*>(a.g), static_cast<const T*>(a.x), a.mean, a.coef, a.gamma_bn,
        a.beta_bn, a.gamma_s, hdu::partials(a.scratch), hdu::counters(a.scratch), a.grads, a.dcoef,
        phase == 1 ? a.sums : nullptr, a.rows, a.c, rd.rows_per_block);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || phase == 1) return rc;
  const Geometry ap = geometry(a.rows, a.c, VEC, 1, 0);
  bn_live_bwd_apply<T, VEC, RELU><<<dim3(ap.blocks, ap.tiles), dim3(ap.tx, ap.ty), 0, a.stream>>>(
      static_cast<const T*>(a.g), static_cast<const T*>(a.x), a.mean, a.coef, a.dcoef,
      static_cast<T*>(a.dx), a.rows, a.c, ap.rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dispatch(int phase, int vec, int relu, const Bwd& a) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return relu ? backward<T, V, true>(phase, a) : backward<T, V, false>(phase, a);
  return relu ? backward<T, 1, true>(phase, a) : backward<T, 1, false>(phase, a);
}

bool bad_phase(int phase, const void* buffer) {
  return phase < 0 || phase > 2 || (phase != 0 && buffer == nullptr);
}

}  // namespace

// x, y: (rows, C), dtype 0 = float32, 1 = bfloat16. gamma_bn, beta_bn: (C,)
// fp32; gamma_s, beta_s: (C,) fp32, or both null without a Scale. phase 0
// (one rank, two launches): writes mean and var (C,) fp32 and coef (3, C)
// fp32 (inv, A, B), then y. phase 1: writes this rank's mean and biased
// variance over its rows, unrounded, to moments (2, C) fp64, and nothing
// else. phase 2: moments holds the merged (2C + 1) fp64 (the global mean
// and variance, then the global row count); writes mean, var, coef and y
// as phase 0 does. The 16-byte path runs when C is a multiple of 16 /
// sizeof(dtype) and x and y are 16-byte aligned, the scalar path otherwise.
// scratch: hdu_scratch_bytes() bytes of the calling stream (common.cuh).
extern "C" int hdu_bn_live_forward(int phase, const void* x, const float* gamma_bn,
                                   const float* beta_bn, const float* gamma_s,
                                   const float* beta_s, float eps, int relu, void* y, float* mean,
                                   float* var, float* coef, double* moments, long long rows, int c,
                                   int dtype, void* scratch, void* stream) {
  if (c <= 0 || rows <= 0 || (dtype != 0 && dtype != 1) || scratch == nullptr ||
      (gamma_s == nullptr) != (beta_s == nullptr) || bad_phase(phase, moments))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = c % (16 / elem) == 0 && aligned16(x) && aligned16(y);
  const Fwd a{x,    gamma_bn, beta_bn, gamma_s, beta_s,  eps,     y, mean,
              var,  coef,     moments, rows,    c,       scratch, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return vec ? forward<float, 4>(phase, relu, a) : forward<float, 1>(phase, relu, a);
  return vec ? forward<__nv_bfloat16, 8>(phase, relu, a) : forward<__nv_bfloat16, 1>(phase, relu, a);
}

// g, x, dx: (rows, C) in one dtype (0 = float32, 1 = bfloat16); mean (C,)
// and coef (3, C) as the forward wrote them; gamma_bn, beta_bn (C,) fp32;
// gamma_s (C,) fp32 or null without a Scale. phase 0 (one rank, two
// launches): writes grads (4, C) fp32 (dgamma_bn, dbeta_bn, dgamma_s,
// dbeta_s; the last two zero without a Scale) and dcoef (3, C) fp32, then
// dx. phase 1: writes this rank's S1 and S2, unrounded, to sums (2, C) fp64,
// and nothing else. phase 2: sums as phase 1 wrote them, merged the (2C +
// 1) fp64 global S1, S2 and row count; grads from sums (this rank's share,
// which the trainer's all-reduce adds), dx from merged. The 16-byte path
// runs when C is a multiple of 16 / sizeof(dtype) and g, x and dx are
// 16-byte aligned.
extern "C" int hdu_bn_live_backward(int phase, const void* g, const void* x, const float* mean,
                                    const float* coef, const float* gamma_bn,
                                    const float* beta_bn, const float* gamma_s, int relu,
                                    void* dx, float* grads, float* dcoef, double* sums,
                                    const double* merged, long long rows, int c, int dtype,
                                    void* scratch, void* stream) {
  if (c <= 0 || rows <= 0 || (dtype != 0 && dtype != 1) || scratch == nullptr ||
      bad_phase(phase, sums) || (phase == 2 && merged == nullptr))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = c % (16 / elem) == 0 && aligned16(g) && aligned16(x) && aligned16(dx);
  const Bwd a{g,    x,      mean, coef, gamma_bn, beta_bn, gamma_s, dx, grads,
              dcoef, sums, merged, rows, c,   scratch,  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return backward_dispatch<float>(phase, vec, relu, a);
  return backward_dispatch<__nv_bfloat16>(phase, vec, relu, a);
}
