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
// width, and pointers that are not 16-byte aligned; the entry point chooses
// the path from its arguments.
//
// The backward (hdu_affine_relu_bwd) is further down, with its own note.
//
// Each launch goes on the caller's stream, allocates nothing (the backward
// uses the caller's scratch, common.cuh) and returns cudaGetLastError(); the
// Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "vec.cuh"

namespace {

using namespace hdu;

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

// 16 blocks of 256 threads per SM.
int max_blocks() { return hdu::sm_count() * 16; }

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

// ---------------------------------------------------------------------------
// K1 backward: the custom VJP of hdenseunet_tpu/ops/fused_affine.py
// (_affine_relu_2d_bwd, :81-89), which the JAX package runs as plain XLA:
//     m = [y > 0] (relu only),  dx = (g*m) * A  in x's dtype,
//     dA = sum_rows (g*m) * x,  dB = sum_rows (g*m)  in fp32, rounded once to
//     x's dtype (JAX casts A and B to x.dtype before the kernel, so its dA
//     and dB come back in that dtype).
// What bounds it: device-memory bytes. Per element it reads g, x and y and
// writes dx, 8 bytes in bf16; dA and dB are per-channel sums. One launch does
// it all. The grid is (row blocks, channel tiles): a block owns a range of
// rows and a tile of at most 32 channel groups of VEC channels
// (threadIdx.x), its rows spread over threadIdx.y. Each thread loads
// kRowUnroll rows of g, x and y before it uses any, so 12 16-byte loads are
// in flight per thread, writes dx and keeps fp32 sums in registers; the block
// folds them through shared memory into one partial pair per channel in the
// scratch. The last block of a tile to arrive (a ticket from the tile's
// counter, after a fence: common.cuh) adds the tile's partials with all its
// threads, each channel in a fixed order and in double, writes dA and dB
// rounded to the dtype and sets the counter back to zero. So dA and dB are
// the same bits on every run, with no float atomics and no second launch.
// One block of 512 threads per SM fills the card (16 warps, 12 loads each in
// flight) and keeps the partials the last block reads to at most one per SM
// per channel; it reads them 4 columns and 8 row blocks at a time, so the
// finish costs a few microseconds, not a pass of its own.
// ---------------------------------------------------------------------------

constexpr int kMaxVec = 8;
constexpr int kRowUnroll = 4;
constexpr int kBwdThreads = 512;
constexpr int kBwdBlocksPerSm = 1;

// Partial sums as the last block reads them: 4 columns at a time with a
// 16-byte load where a tile's width is a multiple of 4, else one.
__device__ __forceinline__ float4 load_cg(const float4* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void add(double (&s)[4], float4 v) {
  s[0] += v.x;
  s[1] += v.y;
  s[2] += v.z;
  s[3] += v.w;
}
__device__ __forceinline__ void add(double (&s)[1], float v) { s[0] += v; }

// Block (tx, ty) of grid (row blocks, tiles). The tile's partials in the
// scratch: (gridDim.x, 2, width) fp32, width = tx * VEC channels, dA sums
// then dB sums; counters[blockIdx.y] is the tile's ticket counter.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
affine_relu_bwd(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ y,
                const float* __restrict__ a, T* __restrict__ dx, float* __restrict__ partial,
                unsigned int* __restrict__ counters, float* __restrict__ da,
                float* __restrict__ db, long long rows, int c, long long rows_per_block) {
  using P = typename Packed<T, VEC>::type;
  __shared__ __align__(16) float red[2][kBwdThreads * kMaxVec];
  const int groups = c / VEC;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = cg < groups;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float sa[VEC], sb[VEC], ar[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    sa[q] = 0.f;
    sb[q] = 0.f;
    ar[q] = active ? rounded<T>(__ldg(a + cg * VEC + q)) : 0.f;
  }
  if (active) {
    const int step = blockDim.y;
    const long long col = (long long)cg * VEC;
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowUnroll * step) {
      P gr[kRowUnroll], xr[kRowUnroll];
      [[maybe_unused]] P yr[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r + u * step < r1) {
          const long long off = (r + u * step) * c + col;
          gr[u] = load_packed<T, VEC>(g + off);
          xr[u] = load_packed<T, VEC>(x + off);
          if constexpr (RELU) yr[u] = load_packed<T, VEC>(y + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (r + u * step < r1) {
          float gv[VEC], xv[VEC], d[VEC];
          unpack<T, VEC>(gr[u], gv);
          unpack<T, VEC>(xr[u], xv);
          if constexpr (RELU) {
            float yv[VEC];
            unpack<T, VEC>(yr[u], yv);
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              if (!(yv[q] > 0.f)) gv[q] = 0.f;  // a NaN y masks too, as jnp.where(y > 0)
          }
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            d[q] = gv[q] * ar[q];  // exact in fp32 for bf16 operands; one rounding on store
            sa[q] = fmaf(gv[q], xv[q], sa[q]);
            sb[q] += gv[q];
          }
          store_vec<T, VEC>(dx + (r + u * step) * c + col, d);
        }
      }
    }
  }

  // The block's sums, each column over threadIdx.y in order, into its
  // partial pair.
  const int width = blockDim.x * VEC;
  const int cols = 2 * width;
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x * VEC;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    red[0][threadIdx.y * width + lane + q] = sa[q];
    red[1][threadIdx.y * width + lane + q] = sb[q];
  }
  __syncthreads();
  float* tile = partial + (long long)blockIdx.y * gridDim.x * cols;
  for (int k = tid; k < cols; k += nt) {
    const float* src = &red[k / width][k % width];
    float s = 0.f;
    for (int t = 0; t < (int)blockDim.y; ++t) s += src[t * width];
    tile[(long long)blockIdx.x * cols + k] = s;
  }
  if (!hdu::arrive_last(counters + blockIdx.y, gridDim.x)) return;

  // The tile's last block: each column's gridDim.x partials in double, in a
  // fixed order. Columns go L at a time; with more threads than column
  // groups the row blocks are split over `slices` threads per group, whose
  // sums are then folded in order through shared memory (red, no longer
  // needed). Each thread has 8 loads in flight before it adds.
  constexpr int L = VEC >= 4 ? 4 : 1;
  using V = typename std::conditional<L == 4, float4, float>::type;
  double* fold = reinterpret_cast<double*>(&red[0][0]);  // slices * cols <= nt * L doubles
  const int nb = gridDim.x;
  const int units = cols / L;
  const int slices = nt >= units ? nt / units : 1;
  const int slice = tid / units;
  auto put = [&](int k, double v) {
    const int ch = blockIdx.y * width + k % width;
    if (ch < c) (k < width ? da : db)[ch] = rounded<T>((float)v);
  };
  for (int u = tid % units; slice < slices && u < units; u += nt) {
    const V* src = reinterpret_cast<const V*>(tile) + u;
    double s[L] = {};
    int b = slice;
    for (; b + 7 * slices < nb; b += 8 * slices) {
      V v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = load_cg(src + (long long)(b + i * slices) * units);
#pragma unroll
      for (int i = 0; i < 8; ++i) add(s, v[i]);
    }
    for (; b < nb; b += slices) add(s, load_cg(src + (long long)b * units));
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (slices == 1) {
        put(u * L + l, s[l]);
      } else {
        fold[slice * cols + u * L + l] = s[l];
      }
    }
  }
  if (slices > 1) {
    __syncthreads();
    for (int k = tid; k < cols; k += nt) {
      double sum = 0.0;
      for (int i = 0; i < slices; ++i) sum += fold[i * cols + k];
      put(k, sum);
    }
  }
  if (tid == 0) counters[blockIdx.y] = 0;
}

struct BwdGeometry {
  int tx, ty, tiles, blocks;
  long long rows_per_block;
};

// Channel tiles of at most 32 groups, as even as the count allows, across
// threadIdx.x; rows across threadIdx.y; kBwdBlocksPerSm blocks per SM in
// all, each a whole number of unrolled row steps, and no more partials than
// the scratch holds.
BwdGeometry bwd_geometry(long long rows, int c, int vec_width) {
  BwdGeometry geo;
  const int groups = c / vec_width;
  geo.tiles = (groups + 31) / 32;
  geo.tx = (groups + geo.tiles - 1) / geo.tiles;
  geo.ty = kBwdThreads / geo.tx;
  const long long per_step = (long long)geo.ty * kRowUnroll;
  const long long fit = hdu::kPartialFloats / ((long long)geo.tiles * 2 * geo.tx * vec_width);
  long long blocks = (long long)hdu::sm_count() * kBwdBlocksPerSm / geo.tiles;
  const long long most = (rows + per_step - 1) / per_step;
  if (blocks > most) blocks = most;
  if (blocks > fit) blocks = fit;
  if (blocks < 1) blocks = 1;
  const long long even = (rows + blocks - 1) / blocks;
  geo.rows_per_block = (even + per_step - 1) / per_step * per_step;
  geo.blocks = (int)((rows + geo.rows_per_block - 1) / geo.rows_per_block);
  return geo;
}

template <typename T, int VEC, bool RELU>
int launch_bwd(const void* g, const void* x, const void* y, const float* a, void* dx,
               float* dadb, void* scratch, long long rows, int c, const BwdGeometry& geo,
               cudaStream_t stream) {
  affine_relu_bwd<T, VEC, RELU><<<dim3(geo.blocks, geo.tiles), dim3(geo.tx, geo.ty), 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(y), a,
      static_cast<T*>(dx), hdu::partials(scratch), hdu::counters(scratch), dadb, dadb + c, rows,
      c, geo.rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* g, const void* x, const void* y, const float* a, void* dx,
                 float* dadb, void* scratch, long long rows, int c, int relu, int vec,
                 const BwdGeometry& geo, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    return relu ? launch_bwd<T, V, true>(g, x, y, a, dx, dadb, scratch, rows, c, geo, s)
                : launch_bwd<T, V, false>(g, x, y, a, dx, dadb, scratch, rows, c, geo, s);
  return relu ? launch_bwd<T, 1, true>(g, x, y, a, dx, dadb, scratch, rows, c, geo, s)
              : launch_bwd<T, 1, false>(g, x, y, a, dx, dadb, scratch, rows, c, geo, s);
}

}  // namespace

// x, y: (rows, C), dtype 0 = float32, 1 = bfloat16; a, b: (C,) fp32. The
// 16-byte vector path runs when C is a multiple of 16 / sizeof(dtype) and
// every pointer is 16-byte aligned, the scalar path otherwise.
extern "C" int hdu_affine_relu(const void* x, const float* a, const float* b, void* y,
                               long long rows, int c, int dtype, int relu, void* stream) {
  if (c <= 0 || rows < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = c % (16 / elem) == 0 && aligned16(x) && aligned16(y) && aligned16(a) &&
                  aligned16(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return relu ? launch<float, true>(x, a, b, y, rows, c, vec, s)
                : launch<float, false>(x, a, b, y, rows, c, vec, s);
  return relu ? launch<__nv_bfloat16, true>(x, a, b, y, rows, c, vec, s)
              : launch<__nv_bfloat16, false>(x, a, b, y, rows, c, vec, s);
}

// g, x, y, dx: (rows, C) in the same dtype (0 = float32, 1 = bfloat16); y is
// read only when relu is set. a: (C,) fp32. dadb: (2, C) fp32, dA then dB,
// each rounded to the dtype. scratch: hdu_scratch_bytes() bytes of the
// calling stream (common.cuh). The 16-byte path runs when C is a multiple of
// 16 / sizeof(dtype) and g, x, y, dx are 16-byte aligned, the scalar path
// otherwise. One kernel launch.
extern "C" int hdu_affine_relu_bwd(const void* g, const void* x, const void* y,
                                   const float* a, void* dx, float* dadb, long long rows,
                                   int c, int dtype, int relu, void* scratch, void* stream) {
  if (c <= 0 || rows <= 0 || (dtype != 0 && dtype != 1) || (relu && y == nullptr) ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = c % (16 / elem) == 0 && aligned16(g) && aligned16(x) && aligned16(dx) &&
                  (!relu || aligned16(y));
  const int width = vec ? 16 / elem : 1;
  const BwdGeometry geo = bwd_geometry(rows, c, width);
  if (geo.tiles > hdu::kTicketSlots ||
      (long long)geo.tiles * geo.blocks * 2 * geo.tx * width > hdu::kPartialFloats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(g, x, y, a, dx, dadb, scratch, rows, c, relu, vec, geo, s);
  return dispatch_bwd<__nv_bfloat16>(g, x, y, a, dx, dadb, scratch, rows, c, relu, vec, geo, s);
}

// Bytes of the per-stream scratch buffer the kernels take (common.cuh).
extern "C" long long hdu_scratch_bytes() { return hdu::kScratchBytes; }

extern "C" const char* hdu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
