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
// The backward (hdu_affine_relu_bwd) is further down, with its own note.
//
// Each launch goes on the caller's stream, allocates nothing and returns
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

// ---------------------------------------------------------------------------
// K1 backward: the custom VJP of hdenseunet_tpu/ops/fused_affine.py
// (_affine_relu_2d_bwd, :81-89), which the JAX package runs as plain XLA:
//     m = [y > 0] (relu only),  dx = (g*m) * A  in x's dtype,
//     dA = sum_rows (g*m) * x,  dB = sum_rows (g*m)  in fp32, rounded once to
//     x's dtype (JAX casts A and B to x.dtype before the kernel, so its dA
//     and dB come back in that dtype).
// What bounds it: device-memory bytes. Per element it reads g, x and y and
// writes dx, 8 bytes in bf16; dA and dB are per-channel sums. One pass does
// it all: a block owns a range of rows and a tile of channels; each thread
// walks rows for its VEC channels with 16-byte loads, writes dx and keeps
// fp32 sums in registers; the block folds those sums through shared memory
// in a fixed order and writes one partial pair per channel. A second small
// kernel adds the blocks' partials in a fixed order (in double), so dA and
// dB are the same bits on every run: no atomics.
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(*p);
  } else {
    __align__(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
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

constexpr int kMaxVec = 8;

// Block (tx, ty): threadIdx.x walks the tile's channel groups of VEC channels,
// threadIdx.y the rows. partial: (gridDim.x, 2, C) fp32, dA sums then dB sums.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(256)
affine_relu_bwd_partial(const T* __restrict__ g, const T* __restrict__ x,
                        const T* __restrict__ y, const float* __restrict__ a,
                        T* __restrict__ dx, float* __restrict__ partial,
                        long long rows, int c, long long rows_per_block) {
  __shared__ float red[2][256 * kMaxVec];
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
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const long long off = r * c + (long long)cg * VEC;
      float gv[VEC], xv[VEC], d[VEC];
      load_vec<T, VEC>(g + off, gv);
      load_vec<T, VEC>(x + off, xv);
      if constexpr (RELU) {
        float yv[VEC];
        load_vec<T, VEC>(y + off, yv);
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
      store_vec<T, VEC>(dx + off, d);
    }
  }
  const int lane = threadIdx.x * VEC;
  const int width = blockDim.x * VEC;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    red[0][threadIdx.y * width + lane + q] = sa[q];
    red[1][threadIdx.y * width + lane + q] = sb[q];
  }
  __syncthreads();
  if (threadIdx.y != 0 || !active) return;
  float* out = partial + (long long)blockIdx.x * 2 * c;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    float ta = 0.f, tb = 0.f;
    for (int t = 0; t < (int)blockDim.y; ++t) {
      ta += red[0][t * width + lane + q];
      tb += red[1][t * width + lane + q];
    }
    out[cg * VEC + q] = ta;
    out[c + cg * VEC + q] = tb;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
affine_relu_bwd_finish(const float* __restrict__ partial, int blocks, int c,
                       float* __restrict__ da, float* __restrict__ db) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double sa = 0.0, sb = 0.0;
  for (int i = 0; i < blocks; ++i) {
    sa += partial[(long long)i * 2 * c + ch];
    sb += partial[(long long)i * 2 * c + c + ch];
  }
  da[ch] = rounded<T>((float)sa);
  db[ch] = rounded<T>((float)sb);
}

struct BwdGeometry {
  int tx, ty, tiles, blocks;
  long long rows_per_block;
};

// Channel tiles of up to 32 groups across threadIdx.x, rows across
// threadIdx.y, and enough row blocks for ~8 blocks per SM in all.
BwdGeometry bwd_geometry(long long rows, int c, int vec_width) {
  BwdGeometry geo;
  const int groups = c / vec_width;
  geo.tx = groups < 32 ? groups : 32;
  geo.ty = 256 / geo.tx;
  geo.tiles = (groups + geo.tx - 1) / geo.tx;
  const long long want = (long long)max_blocks() / 2 / geo.tiles;
  const long long most = (rows + geo.ty - 1) / geo.ty;
  long long blocks = want < most ? want : most;
  if (blocks < 1) blocks = 1;
  geo.rows_per_block = (rows + blocks - 1) / blocks;
  geo.blocks = (int)((rows + geo.rows_per_block - 1) / geo.rows_per_block);
  if (geo.blocks < 1) geo.blocks = 1;
  return geo;
}

template <typename T, int VEC, bool RELU>
int launch_bwd(const void* g, const void* x, const void* y, const float* a, void* dx,
               float* partial, float* da, float* db, long long rows, int c,
               const BwdGeometry& geo, cudaStream_t stream) {
  dim3 grid(geo.blocks, geo.tiles);
  dim3 block(geo.tx, geo.ty);
  affine_relu_bwd_partial<T, VEC, RELU><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(y), a,
      static_cast<T*>(dx), partial, rows, c, geo.rows_per_block);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  affine_relu_bwd_finish<T><<<(c + 255) / 256, 256, 0, stream>>>(partial, geo.blocks, c, da, db);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* g, const void* x, const void* y, const float* a, void* dx,
                 float* partial, float* da, float* db, long long rows, int c, int relu,
                 int vec, const BwdGeometry& geo, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    return relu ? launch_bwd<T, V, true>(g, x, y, a, dx, partial, da, db, rows, c, geo, s)
                : launch_bwd<T, V, false>(g, x, y, a, dx, partial, da, db, rows, c, geo, s);
  return relu ? launch_bwd<T, 1, true>(g, x, y, a, dx, partial, da, db, rows, c, geo, s)
              : launch_bwd<T, 1, false>(g, x, y, a, dx, partial, da, db, rows, c, geo, s);
}

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

// fp32 values of scratch that hdu_affine_relu_bwd needs for these arguments.
extern "C" long long hdu_affine_relu_bwd_workspace(long long rows, int c, int dtype, int vec) {
  const int elem = dtype == 0 ? 4 : 2;
  if (c <= 0 || rows <= 0) return 0;
  const BwdGeometry geo = bwd_geometry(rows, c, vec ? 16 / elem : 1);
  return (long long)geo.blocks * 2 * c;
}

// g, x, y, dx: (rows, C) in the same dtype (0 = float32, 1 = bfloat16); y is
// read only when relu is set. a: (C,) fp32. da, db: (C,) fp32, each rounded
// to the dtype. partial: workspace of hdu_affine_relu_bwd_workspace floats.
// vec: 1 = 16-byte path, which needs C a multiple of 16 / sizeof(dtype) and
// g, x, y, dx 16-byte aligned.
extern "C" int hdu_affine_relu_bwd(const void* g, const void* x, const void* y,
                                   const float* a, void* dx, float* partial,
                                   long long workspace, float* da, float* db,
                                   long long rows, int c, int dtype, int relu, int vec,
                                   void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (c <= 0 || rows <= 0 || (dtype != 0 && dtype != 1) || (relu && y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec && (c % (16 / elem) != 0 || !aligned16(g) || !aligned16(x) || !aligned16(dx) ||
              (relu && !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  const BwdGeometry geo = bwd_geometry(rows, c, vec ? 16 / elem : 1);
  if (workspace < (long long)geo.blocks * 2 * c) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(g, x, y, a, dx, partial, da, db, rows, c, relu, vec, geo, s);
  return dispatch_bwd<__nv_bfloat16>(g, x, y, a, dx, partial, da, db, rows, c, relu, vec, geo, s);
}

extern "C" const char* hdu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
