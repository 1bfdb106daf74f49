// K5: the dense blocks' 1x1 convolution as one GEMM with the folded frozen
// BN∘Scale∘ReLU in front of it as its prologue and, optionally, the next one
// as its epilogue, for sm_90a:
//
//   y[m, n] = epi( sum_k  bf16(relu(fmaf(x[m, k], A1[k], B1[k]))) * w[n, k] )
//   epi(v)  = bf16(relu(fmaf(bf16(v), A2[n], B2[n])))      (or bf16(v) alone)
//
// It takes the place of K1 -> conv1x1 -> K1 (csrc/fused_affine.cu and a cuDNN
// convolution) on the serving path. The JAX package has no Pallas kernel for
// this: its serving path leaves the folded affine+ReLU to XLA, which fuses it
// into the neighbouring convolutions (hdenseunet_tpu/ops/fused_affine.py:13-18,
// the default route :95-110); this is the port's counterpart of that fusion.
// x is a channels-last activation seen as (M rows, K channels) with a row
// stride ld >= K: the first K channels of a wider dense-block buffer are read
// in place, so the block's concatenation is never copied. w is the 1x1 kernel
// as (N, K), y a contiguous (M, N) matrix. A and B are float32 vectors rounded
// to the working dtype as they are read, as K1 reads them.
//
// What bounds it on the H100: device-memory bytes. At the served
// bottlenecks (K 96-2160, N 128 or 192) a product reads ~K*2 bytes of x per
// row for 2*N*K FLOP, at most ~192 FLOP a byte against the card's ridge of
// ~295, so the bytes set the bound (the 384- and 1056-wide transitions alone
// are bound by their operations), and the prologue and epilogue ride on
// them: the unfused chain
// reads and writes every operand twice more (K1 in front) and every output
// twice more (K1 behind). The kernel reads x once and writes y once.
//
// Design (bfloat16): a block computes a BM x BN tile of y over K in k-tiles
// of BK = 64 channels. 256 threads copy the k-tiles of x and w into a ring of
// S shared-memory stages with cp.async (16 bytes a thread and copy,
// zero-filled past M, N and K), rows of 128 bytes XOR-swizzled so that
// ldmatrix reads 8 rows without bank conflicts. When a stage has landed, each
// thread applies the prologue in place to the 16-byte chunks of x it copied
// itself (the same 8 channels on every row it copies: their A1 and B1 are
// fetched a k-tile ahead); chunks past K stay zero, so the K tail meets w's
// zero padding instead of relu(B1). Then 8 warps (2 x 4) run mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) on fragments read with ldmatrix, while
// the next stages' copies are in flight. The sums are rounded to bf16, take
// the optional affine+ReLU and are staged in the freed ring, then stored as
// 16-byte chunks of y's rows. N up to 256 is one tile (BN 64-256); wider N
// splits into tiles of 192, adjacent in the grid so that they share x's tile
// in L2. Fewer than two 128-row tiles an SM take BM = 64 with 3 stages, two
// blocks an SM. This is the first form, mma.sync and cp.async: it runs at
// 10-43 % of its bound on the served shapes, its loads (w's tiles from L2),
// prologue and products taking turns (PERF.md); wgmma with TMA is next.
//
// float32 (the audit paths: parity dumps, float32 serving) takes a plain
// SIMT tiling with the same prologue and epilogue in fp32 arithmetic.
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper (ops/affine_gemm.py) checks shapes,
// strides and alignment and raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BK = 64;  // channels a k-tile: rows of 128 bytes, 8 chunks of 16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c (0-7) of row r in a tile of 128-byte rows,
// XOR-swizzled: the 8 rows an ldmatrix reads at one chunk land in 8 banks groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K1's arithmetic (fused_affine.cu: affine<true>): one fused multiply-add,
// then a ReLU that lets NaN through, as torch.relu
__device__ __forceinline__ float affine_relu(float x, float a, float b) {
  float y = fmaf(x, a, b);
  return y < 0.f ? 0.f : y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S shared-memory stages; 64-row tiles take 3 and run two blocks an SM
template <int BM, int BN, int S>
__global__ void __launch_bounds__(kThreads, BM == 64 ? 2 : 1)
affine_gemm_bf16(const __nv_bfloat16* __restrict__ x, long long ld,
                 const __nv_bfloat16* __restrict__ w, const float* __restrict__ a1,
                 const float* __restrict__ b1, const float* __restrict__ a2,
                 const float* __restrict__ b2, __nv_bfloat16* __restrict__ y, long long M,
                 int K, int N, int n_tiles) {
  constexpr int WM = BM / 2, WN = BN / 4;  // a warp's tile: 2 x 4 warps
  constexpr int MT = WM / 16, NT = WN / 8;  // its m16 and n8 tiles
  static_assert(NT % 2 == 0, "B fragments are read two n8 tiles at a time");
  constexpr int A_BYTES = BM * BK * 2, STAGE = (BM + BN) * BK * 2;
  constexpr int A_ROWS = BM / 32, W_ROWS = BN / 32;  // rows a thread copies

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int k_tiles = (K + BK - 1) / BK;
  const uint32_t base = smem_u32(smem);
  // this thread copies chunk cc of rows r0, r0 + 32, ... of both tiles
  const int cc = tid & 7, r0 = tid >> 3;

  auto load = [&](int kt, int slot) {
    const int k = kt * BK + cc * 8;
    const bool k_in = k < K;
    const uint32_t sa = base + slot * STAGE, sw = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int r = r0 + 32 * i;
      const bool ok = k_in && m0 + r < M;
      cp_async16(sa + swz(r, cc), ok ? x + (m0 + r) * ld + k : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < W_ROWS; ++i) {
      const int r = r0 + 32 * i;
      const bool ok = k_in && n0 + r < N;
      cp_async16(sw + swz(r, cc), ok ? w + (long long)(n0 + r) * K + k : w, ok ? 16 : 0);
    }
  };

  // A1 and B1 of the 8 channels whose chunk this thread copies in k-tile kt
  auto fetch_ab = [&](int kt, float4 (&ab)[4]) {
    const int k = kt * BK + cc * 8;
    if (k >= K) return;
    const float4* av = reinterpret_cast<const float4*>(a1 + k);
    const float4* bv = reinterpret_cast<const float4*>(b1 + k);
    ab[0] = __ldg(av);
    ab[1] = __ldg(av + 1);
    ab[2] = __ldg(bv);
    ab[3] = __ldg(bv + 1);
  };

  // the prologue on this thread's own chunks of x, once they have landed
  auto prologue = [&](int kt, int slot, const float4 (&ab)[4]) {
    const int k = kt * BK + cc * 8;
    if (k >= K) return;  // zero-filled: stays zero, to meet w's zero padding
    const float sa[8] = {round_bf16(ab[0].x), round_bf16(ab[0].y), round_bf16(ab[0].z),
                         round_bf16(ab[0].w), round_bf16(ab[1].x), round_bf16(ab[1].y),
                         round_bf16(ab[1].z), round_bf16(ab[1].w)};
    const float sb[8] = {round_bf16(ab[2].x), round_bf16(ab[2].y), round_bf16(ab[2].z),
                         round_bf16(ab[2].w), round_bf16(ab[3].x), round_bf16(ab[3].y),
                         round_bf16(ab[3].z), round_bf16(ab[3].w)};
    unsigned char* tile = smem + slot * STAGE;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      uint4* p = reinterpret_cast<uint4*>(tile + swz(r0 + 32 * i, cc));
      uint4 v = *p;
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 e = *reinterpret_cast<const __nv_bfloat162*>(&u[j]);
        u[j] = pack_bf16(affine_relu(__low2float(e), sa[2 * j], sb[2 * j]),
                         affine_relu(__high2float(e), sa[2 * j + 1], sb[2 * j + 1]));
      }
      *p = v;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int kt, int slot) {
    const uint32_t sa = base + slot * STAGE, sw = sa + A_BYTES;
    const int k_left = K - kt * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks * 16 < k_left) {  // the K tail's last 16 may hold 8 zero-filled channels
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], sa + swz(wm * WM + mt * 16 + (lane & 15), ks * 2 + (lane >> 4)));
        uint32_t bf[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t t[4];
          ldmatrix_x4(t, sw + swz(wn * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  ks * 2 + ((lane >> 3) & 1)));
          bf[2 * np][0] = t[0];
          bf[2 * np][1] = t[1];
          bf[2 * np + 1][0] = t[2];
          bf[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_commit();
  }
  float4 ab[4];  // A1 and B1 of this thread's 8 channels of the next k-tile
  fetch_ab(0, ab);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int slot = kt % S;
    cp_wait<S - 2>();  // this thread's copies of k-tile kt have landed
    prologue(kt, slot, ab);
    if (kt + 1 < k_tiles) fetch_ab(kt + 1, ab);  // in flight while k-tile kt is multiplied
    __syncthreads();  // every copy and prologue of k-tile kt done; k-tile kt - 1 read by all
    const int next = kt + S - 1;
    if (next < k_tiles) load(next, next % S);  // into k-tile kt - 1's slot
    cp_commit();
    compute(kt, slot);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it stages the output tile

  // The output tile, each sum rounded to bf16 and through the optional
  // epilogue, staged in shared memory (rows padded by 16 bytes: the pairs a
  // warp writes fall in 32 banks), then stored as 16-byte row chunks.
  constexpr int YROW = BN * 2 + 16;
  static_assert(BM * YROW <= S * STAGE, "the output tile fits in the ring");
  const int g = lane >> 2, t4 = lane & 3;
  const bool epi = a2 != nullptr;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn * WN + nt * 8 + 2 * t4;  // in the tile
    const int col = min(n0 + c, N - 2);  // a column past N is computed, never stored
    float ea0 = 0.f, ea1 = 0.f, eb0 = 0.f, eb1 = 0.f;
    if (epi) {
      ea0 = round_bf16(__ldg(a2 + col)); ea1 = round_bf16(__ldg(a2 + col + 1));
      eb0 = round_bf16(__ldg(b2 + col)); eb1 = round_bf16(__ldg(b2 + col + 1));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = round_bf16(acc[mt][nt][2 * h]), v1 = round_bf16(acc[mt][nt][2 * h + 1]);
        if (epi) {
          v0 = affine_relu(v0, ea0, eb0);
          v1 = affine_relu(v1, ea1, eb1);
        }
        const int r = wm * WM + mt * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(smem + r * YROW + c * 2) = pack_bf16(v0, v1);
      }
    }
  }
  __syncthreads();
  const int rows = (int)min((long long)BM, M - m0), chunks = min(BN, N - n0) / 8;
  for (int i = tid; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<uint4*>(y + (m0 + r) * N + n0 + c * 8) =
        *reinterpret_cast<const uint4*>(smem + r * YROW + c * 16);
  }
}

// float32: a 64 x 64 tile a block, 16 channels a step, 4 x 4 outputs a thread
constexpr int FB = 64, FK = 16;

__global__ void __launch_bounds__(kThreads)
affine_gemm_f32(const float* __restrict__ x, long long ld, const float* __restrict__ w,
                const float* __restrict__ a1, const float* __restrict__ b1,
                const float* __restrict__ a2, const float* __restrict__ b2,
                float* __restrict__ y, long long M, int K, int N) {
  __shared__ float xs[FK][FB + 4], ws[FK][FB + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * FB;
  const int n0 = blockIdx.y * FB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < FB * FK / kThreads; ++i) {
      const int e = tid + kThreads * i, r = e / FK, kk = e % FK, k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      xs[kk][r] = k < K && m < M ? affine_relu(x[m * ld + k], __ldg(a1 + k), __ldg(b1 + k)) : 0.f;
      ws[kk][r] = k < K && n < N ? w[(long long)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = xs[kk][ty * 4 + i];
        bv[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (a2 != nullptr) v = affine_relu(v, __ldg(a2 + n), __ldg(b2 + n));
      y[m * N + n] = v;
    }
  }
}

template <int BM, int BN, int S = BM == 64 ? 3 : 4>
int launch_bf16(const void* x, long long ld, const void* w, const float* a1, const float* b1,
                const float* a2, const float* b2, void* y, long long M, int K, int N,
                cudaStream_t stream) {
  constexpr int smem = S * (BM + BN) * BK * 2;
  static bool opted[hdu::kMaxDevices] = {};  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= hdu::kMaxDevices || !opted[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        affine_gemm_bf16<BM, BN, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    if (dev >= 0 && dev < hdu::kMaxDevices) opted[dev] = true;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks = (M + BM - 1) / BM * n_tiles;
  affine_gemm_bf16<BM, BN, S><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ld, static_cast<const __nv_bfloat16*>(w), a1, b1, a2,
      b2, static_cast<__nv_bfloat16*>(y), M, K, N, n_tiles);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bn(int bn, const void* x, long long ld, const void* w, const float* a1,
              const float* b1, const float* a2, const float* b2, void* y, long long M, int K,
              int N, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch_bf16<BM, 64>(x, ld, w, a1, b1, a2, b2, y, M, K, N, stream);
    case 128: return launch_bf16<BM, 128>(x, ld, w, a1, b1, a2, b2, y, M, K, N, stream);
    case 192: return launch_bf16<BM, 192>(x, ld, w, a1, b1, a2, b2, y, M, K, N, stream);
    default: return launch_bf16<BM, 256>(x, ld, w, a1, b1, a2, b2, y, M, K, N, stream);
  }
}

}  // namespace

extern "C" {

// y (M, N) = [epilogue] ( prologue(x (M, K), row stride ld) @ w (N, K)^T ).
// dtype 0: float32, 1: bfloat16. a2 == nullptr: no epilogue (b2 unread).
// bfloat16 takes K and N multiples of 8, ld a multiple of 8 and x, w, y
// 16-byte aligned, as the wrapper checks; a1, b1 16-byte aligned.
int hdu_affine_gemm(const void* x, long long ld, const void* w, const float* a1,
                    const float* b1, const float* a2, const float* b2, void* y, long long M,
                    int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    const dim3 grid((unsigned)((M + FB - 1) / FB), (unsigned)((N + FB - 1) / FB));
    affine_gemm_f32<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), ld,
                                              static_cast<const float*>(w), a1, b1, a2, b2,
                                              static_cast<float*>(y), M, K, N);
    return (int)cudaGetLastError();
  }
  // N up to 256 in one tile, wider N in tiles of 192
  const int bn = N <= 64 ? 64 : N <= 128 ? 128 : N <= 192 ? 192 : N <= 256 ? 256 : 192;
  const long long tiles = (M + 127) / 128 * ((N + bn - 1) / bn);
  if (tiles < 2LL * hdu::sm_count())
    return launch_bn<64>(bn, x, ld, w, a1, b1, a2, b2, y, M, K, N, s);
  return launch_bn<128>(bn, x, ld, w, a1, b1, a2, b2, y, M, K, N, s);
}

}  // extern "C"
