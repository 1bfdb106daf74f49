// K3: the device scorer's window accumulate and finish, for sm_90a.
//
// Replaces the XLA program that hdenseunet_tpu/infer/device_pipeline.py fuses
// into its jitted scoring (no Pallas body there):
//   K3a window_accumulate: the fp32 softmax of each window's logits, the two
//       z-edge slices dropped, then score += w * p and count += w per window,
//       in window order (_score_volume_dedup2d :1178-1190; the same acc loop
//       in _score_volume :156-168 and _score_volume_shared2d :969-979);
//   K3b score_finish: score / (count + 1e-4), liver >= t_l and tumour >= t_t
//       to the labels {0, 1, 3} (bit 0 liver or tumour, bit 1 tumour), as a
//       uint8 mask or as the 2-bit wire, 4 z voxels a byte, the first in the
//       low bits, over the first pack_z slices (:1195-1200, _pack_labels
//       :185, _pack2bits :193).
//
// Both give the bits of the port's plain versions (ops/score.py) on the
// card, so every voxel repeats the plain arithmetic in its order:
//   - the softmax as torch's persistent warp softmax computes a row of C <= 4
//     classes: the max, e_c = expf(l_c - max), the sum over a butterfly of
//     P lanes (P the power of two >= C, zeros past C; (e0 + e2) + e1 for
//     C = 3), p_c = e_c / sum with IEEE division;
//   - score + w * p as one fused multiply-add, the contraction nvcc makes of
//     torch's add_(p, alpha=w); count + w as one add;
//   - windows in ascending batch order, so each voxel's sum is rounded in the
//     plain loop's order; count + 1e-4f rounded to fp32 before the divide;
//     thresholds compared in fp32, as torch compares an fp32 tensor with a
//     Python float.
//
// Layouts: score (X, Y, zp, C) fp32 and count (zp,) fp32, contiguous; logits
// (wb, X, Y, cols, C) fp32 or bf16 read through their strides, so the
// d-major order of layout3d='dhwc' needs no copy (it reads uncoalesced).
//
// What bounds it on the H100: device-memory bytes. K3a reads each live
// window's interior logits once and reads and writes the batch's z-span of
// the score buffer once. One block takes a tile of (x, y) rows: first the
// tile's softmaxes, one a (window, row, slice), go to shared memory; then
// one thread owns one voxel of the tile's span, loads its C scores, adds
// every live window that covers z in order and stores once. No atomics, so
// every run gives the same bits. The first form, one thread a voxel that
// computed its covering windows' softmaxes itself, ran at a fifth of the
// bound: a warp's lanes span the whole z-span, so the warp ran the softmax
// of every window of the batch with a third of its lanes (PERF.md).
// The count is a function of the starts and weights alone: block 0 adds it
// in the same order. K3b reads the score buffer's first pack_z slices and
// the count once and writes the labels or the wire once; the average is
// never written. The plain versions make a softmax pass, an fp32 copy of the
// logits and a strided read-modify-write per window (K3a), and a divide,
// seven threshold passes and eight pack passes (K3b).
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindows = 64;  // live windows in one batch: ops/score.py's MAX_WINDOWS
constexpr int kMaxTileRows = 64;  // (x, y) rows a block of K3a
constexpr int kTileBytes = 48 * 1024;  // K3a's shared memory a block, the default limit

// The batch's live windows (weight != 0), in batch order: the logits' batch
// index, the start in the score buffer and the weight.
struct Windows {
  int n;
  int index[kMaxWindows];
  int start[kMaxWindows];
  float weight[kMaxWindows];
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The softmax of one row of C logits read at stride sc, as torch's
// persistent warp softmax rounds it (see the note at the top).
template <int C, typename T>
__device__ __forceinline__ void softmax_row(const T* row, long long sc, float (&p)[C]) {
  constexpr int P = C <= 2 ? 2 : 4;
  float l[C];
#pragma unroll
  for (int c = 0; c < C; ++c) l[c] = load(row + c * sc);
  float m = l[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = m > l[c] ? m : l[c];
  float lane[P];
#pragma unroll
  for (int c = 0; c < P; ++c) lane[c] = c < C ? expf(l[c] - m) : 0.0f;
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = lane[c];
#pragma unroll
  for (int off = P / 2; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < off; ++c) lane[c] = lane[c] + lane[c + off];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = e[c] / lane[0];
}

// One block a tile of R (x, y) rows of the batch's z-span [z0, z0 + span).
// First every live window's interior probabilities of the tile go to shared
// memory, one softmax a (window, row, slice), neighbouring threads on
// neighbouring slices and rows, so every lane of a warp does work and reads
// neighbouring logits; then one thread a voxel (row, z), z fastest, loads its
// C scores, adds every window that covers z in window order from shared
// memory and stores once.
template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
window_accumulate_kernel(float* __restrict__ score, float* __restrict__ count,
                         const T* __restrict__ logits, const __grid_constant__ Windows win,
                         int rows_total, int Y, int zp, int cols, int z0, int span, int R,
                         long long sb, long long sx, long long sy, long long sz, long long sc) {
  extern __shared__ float probs[];  // [window][row of the tile][interior slice][C]
  const int inner = cols - 2;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, rows_total - row0);
  const int per_window = rows * inner;
#pragma unroll 4
  for (int i = threadIdx.x; i < win.n * per_window; i += kThreads) {
    const int k = i / per_window;
    const int rem = i - k * per_window;
    const int r = rem / inner, kz = rem - r * inner;
    const int row = row0 + r;
    const int x = row / Y, y = row - x * Y;
    float p[C];
    softmax_row<C>(logits + win.index[k] * sb + x * sx + y * sy + (kz + 1) * sz, sc, p);
    float* dst = probs + ((k * R + r) * inner + kz) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = p[c];
  }
  if (blockIdx.x == 0) {  // the count, once a z, in window order
    for (int dz = threadIdx.x; dz < span; dz += kThreads) {
      const int z = z0 + dz;
      float cn = count[z];
      for (int k = 0; k < win.n; ++k) {
        const int kz = z - win.start[k] - 1;
        if (kz >= 0 && kz < inner) cn = cn + win.weight[k];
      }
      count[z] = cn;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * span; i += kThreads) {
    const int r = i / span, z = z0 + (i - r * span);
    float* out = score + ((long long)(row0 + r) * zp + z) * C;
    float s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = out[c];
    for (int k = 0; k < win.n; ++k) {
      const int kz = z - win.start[k] - 1;  // the window's interior slice
      if (kz < 0 || kz >= inner) continue;
      const float* p = probs + ((k * R + r) * inner + kz) * C;
      const float w = win.weight[k];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = fmaf(w, p[c], s[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = s[c];
  }
}

template <int C>
__device__ __forceinline__ unsigned label_of(const float* s, float denom, float t_liver,
                                             float t_tumor) {
  const bool liver = s[C - 2] / denom >= t_liver;
  const bool tumor = s[C - 1] / denom >= t_tumor;
  return (unsigned)(liver | tumor) + 2u * (unsigned)tumor;
}

// WIRE: one thread a wire byte (4 z voxels); else one thread a voxel.
template <int C, bool WIRE>
__global__ void __launch_bounds__(kThreads)
score_finish_kernel(const float* __restrict__ score, const float* __restrict__ count,
                    uint8_t* __restrict__ out, int zp, int pack_z, long long items,
                    float t_liver, float t_tumor) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  constexpr int kPer = WIRE ? 4 : 1;
  const int per_row = pack_z / kPer;
  const long long row = t / per_row;
  const int z = (int)(t - row * per_row) * kPer;
  const float* s = score + (row * zp + z) * C;
  unsigned packed = 0u;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    packed |= label_of<C>(s + i * C, count[z + i] + 1e-4f, t_liver, t_tumor) << (2 * i);
  out[t] = (uint8_t)packed;
}

long long blocks_for(long long items) { return (items + kThreads - 1) / kThreads; }

// The tile: as many rows as kMaxTileRows, or as the probabilities of the
// live windows fit in kTileBytes of shared memory.
template <int C, typename T>
int launch_accumulate(float* score, float* count, const T* logits, const Windows& win, int X,
                      int Y, int zp, int cols, int z0, int span, const long long* strides,
                      cudaStream_t stream) {
  const int row_bytes = win.n * (cols - 2) * C * (int)sizeof(float);
  const int R = std::min(kMaxTileRows, kTileBytes / row_bytes);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const int rows = X * Y;
  window_accumulate_kernel<C, T><<<(rows + R - 1) / R, kThreads, R * row_bytes, stream>>>(
      score, count, logits, win, rows, Y, zp, cols, z0, span, R, strides[0], strides[1],
      strides[2], strides[3], strides[4]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_accumulate(int C, float* score, float* count, const void* logits, const Windows& win,
                        int X, int Y, int zp, int cols, int z0, int span,
                        const long long* strides, cudaStream_t stream) {
  const T* l = static_cast<const T*>(logits);
  switch (C) {
    case 2: return launch_accumulate<2>(score, count, l, win, X, Y, zp, cols, z0, span, strides, stream);
    case 3: return launch_accumulate<3>(score, count, l, win, X, Y, zp, cols, z0, span, strides, stream);
    default: return launch_accumulate<4>(score, count, l, win, X, Y, zp, cols, z0, span, strides, stream);
  }
}

template <int C>
int launch_finish(const float* score, const float* count, uint8_t* out, int X, int Y, int zp,
                  int pack_z, bool wire, float t_liver, float t_tumor, cudaStream_t stream) {
  const long long items = (long long)X * Y * (wire ? pack_z / 4 : pack_z);
  if (wire)
    score_finish_kernel<C, true><<<blocks_for(items), kThreads, 0, stream>>>(
        score, count, out, zp, pack_z, items, t_liver, t_tumor);
  else
    score_finish_kernel<C, false><<<blocks_for(items), kThreads, 0, stream>>>(
        score, count, out, zp, pack_z, items, t_liver, t_tumor);
  return (int)cudaGetLastError();
}

}  // namespace

// score: (X, Y, zp, C) fp32 and count: (zp,) fp32, contiguous, updated in
// place; logits: (wb, X, Y, cols, C), dtype 0 = float32, 1 = bfloat16, at
// strides (5 element strides, batch first); C in 2..4. The n live windows
// (host arrays): the logits' batch index, the start and the weight, in
// batch order, each inside the buffer (0 <= start, start + cols <= zp). One
// launch over the z-span the windows' interiors cover.
extern "C" int hdu_window_accumulate(float* score, float* count, const void* logits, int dtype,
                                     int X, int Y, int zp, int C, int cols,
                                     const long long* strides, int n, const int* index,
                                     const int* starts, const float* weights, void* stream) {
  if (X <= 0 || Y <= 0 || zp <= 0 || C < 2 || C > 4 || cols < 3 || cols > zp || n < 1 ||
      n > kMaxWindows || (dtype != 0 && dtype != 1) || strides == nullptr ||
      (long long)X * Y >= (long long)INT_MAX)
    return (int)cudaErrorInvalidValue;
  Windows win;
  win.n = n;
  int lo = zp, hi = 0;
  for (int k = 0; k < n; ++k) {
    if (starts[k] < 0 || starts[k] + cols > zp || index[k] < 0 || weights[k] == 0.0f)
      return (int)cudaErrorInvalidValue;
    win.index[k] = index[k];
    win.start[k] = starts[k];
    win.weight[k] = weights[k];
    lo = starts[k] + 1 < lo ? starts[k] + 1 : lo;
    hi = starts[k] + cols - 1 > hi ? starts[k] + cols - 1 : hi;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_accumulate<float>(C, score, count, logits, win, X, Y, zp, cols, lo, hi - lo,
                                      strides, s);
  return dispatch_accumulate<__nv_bfloat16>(C, score, count, logits, win, X, Y, zp, cols, lo,
                                            hi - lo, strides, s);
}

// score: (X, Y, zp, C) fp32, count: (zp,) fp32, contiguous; C in 2..4.
// out: uint8, (X, Y, pack_z) labels {0, 1, 3}, or with wire (X, Y,
// pack_z / 4) 2-bit bytes, pack_z a multiple of 4. pack_z <= zp. One launch.
extern "C" int hdu_score_finish(const float* score, const float* count, uint8_t* out, int X,
                                int Y, int zp, int C, int pack_z, int wire, float t_liver,
                                float t_tumor, void* stream) {
  if (X <= 0 || Y <= 0 || zp <= 0 || C < 2 || C > 4 || pack_z <= 0 || pack_z > zp ||
      (wire && pack_z % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 2: return launch_finish<2>(score, count, out, X, Y, zp, pack_z, wire, t_liver, t_tumor, s);
    case 3: return launch_finish<3>(score, count, out, X, Y, zp, pack_z, wire, t_liver, t_tumor, s);
    default: return launch_finish<4>(score, count, out, X, Y, zp, pack_z, wire, t_liver, t_tumor, s);
  }
}
