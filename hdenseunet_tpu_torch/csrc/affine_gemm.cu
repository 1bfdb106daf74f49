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
// What bounds it on the H100. The bottlenecks (K 96-2160, N 128 or 192) do
// 2NK operations a row for 2K + 2N bytes, under 192 a byte against the card's
// ridge of ~295: device-memory bytes bound them, the output's as much as the
// input's at small K. The 384- and 1056-wide 2D transitions are bound by
// their operations; the 3D stages 4-5 (4,096-16,384 rows, a few microseconds)
// by the launch and the pipeline's fill. The kernel reads x once and writes
// y once; the unfused chain reads and writes each twice more.
//
// Design (bfloat16), one persistent block an SM walking 128 x BN output
// tiles (BN 128, 192 or 256 by N; wider N in tiles of 192, the N tiles of an
// M tile adjacent so that they share x's tile in L2; every block of a
// bottleneck reads the same w tile, kept in L2):
// - TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the edges)
//   brings x's and w's 64-channel k-tiles into a ring of 3-5 stages, each
//   with a full and an empty mbarrier. x's tensor map spans K channels, never
//   ld: its zero fill past K meets w's, and the buffer's later channels,
//   which torch.empty leaves as any bits, are never read.
// - Warp specialisation: in the third warpgroup (its registers lowered with
//   setmaxnreg), one thread starts the TMA loads and one warp stages each
//   k-tile's A1 and B1 beside it, rounded to bf16 and zero past K, so that the
//   tail's zero-filled channels give relu(0) = 0, not relu(B1).
// - Two consumer warpgroups, 64 rows each: ldmatrix reads the landed x
//   k-tile (mma.sync's A fragment layout is wgmma's register-A layout, the
//   swizzle the XOR that TMA wrote), the prologue runs in registers (fmaf,
//   then relu and the bf16 rounding in one cvt), and wgmma.mma_async
//   m64nBNk16 takes A from those registers and w's tile from shared memory,
//   fp32 accumulate. One k-tile's products run while the next k-tile goes
//   through the prologue; a stage is released once its products have read
//   it. The prologue in registers costs no shared-memory round trip; a
//   producer-side rewrite of the tile in shared memory was not built.
// - The epilogue rounds each whole sum to bf16, applies A2, B2 (staged once
//   a launch, rounded) and the relu, stages the tile in shared memory of its
//   own (128-byte swizzled boxes of 64 columns) and stores it with TMA,
//   clipped at M and N, while the ring already fills with the next tile.
// Two alternatives were built and measured slower at every served shape
// where they applied, and are not kept: w multicast over a cluster of two M
// tiles (the cluster's blocks wait on each other's releases), and split-K
// over clusters of 2-4 blocks for the small-M shapes (partials summed
// through distributed shared memory; the extra cluster barriers and the
// partials' round trip cost more than the idle SMs it filled).
//
// float32 (the audit paths: parity dumps, float32 serving) takes a plain
// SIMT tiling with the same prologue and epilogue in fp32 arithmetic.
//
// Each launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper (ops/affine_gemm.py) checks shapes,
// strides and alignment and raises on a non-zero code.

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // the float32 tiling
constexpr int BK = 64;                    // channels a k-tile: rows of 128 bytes, 8 chunks of 16
constexpr int kTmaBM = 128;               // rows a tile: two consumer warpgroups of 64
constexpr int kTmaThreads = 384;          // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int kXTile = kTmaBM * BK * 2;   // 16 KB: a k-tile of x, 128 rows of 128 bytes
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;          // shared memory a block may take

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offset of 16-byte chunk c (0-7) of row r in a 1024-byte-aligned tile
// of 128-byte rows under TMA's 128-byte swizzle: the 8 rows an ldmatrix
// reads at one chunk land in 8 bank groups.
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

// bf16 pair (lo, hi) of relu(lo), relu(hi), rounded to nearest even (NaN
// stays NaN, as torch.relu leaves it)
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// a box of a 2-D tensor map (inner coordinate first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// wgmma's descriptor of a K-major operand tile of 128-byte rows with the
// 128-byte swizzle TMA writes: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x N fp32, the warpgroup's accumulator fragment) += a (64 x 16 bf16,
// registers: per warp mma.sync's m16n8k16 A fragment) * b (16 x N, K-major
// in shared memory). d[i] holds row 16 * warp + lane / 4 + 8 * (i / 2 % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int BN>
struct TmaLayout {
  static constexpr int S = BN == 256 ? 3 : BN == 192 ? 4 : 5;  // ring stages
  static constexpr int W_TILE = BN * BK * 2;
  static constexpr int X_OFF = 0, W_OFF = S * kXTile;
  static constexpr int OUT_OFF = W_OFF + S * W_TILE;  // per warpgroup 64 rows, boxes of 64 columns
  static constexpr int OUT_WG = 64 * BN * 2;
  static constexpr int AB_OFF = OUT_OFF + 2 * OUT_WG;  // A1[64], B1[64] a stage, rounded
  static constexpr int BAR_OFF = AB_OFF + S * 2 * BK * 4;
  static constexpr int EPI_OFF = BAR_OFF + 2 * S * 8;  // A2, B2 of every column, rounded
  static constexpr int ACC = BN / 2;                   // accumulators a consumer thread
  // with 2 * n_pad floats of A2 and B2 (n_pad: N rounded up to BN), and
  // slack to align the base to 1024 bytes
  static int bytes(int n_pad) { return EPI_OFF + 2 * n_pad * 4 + 1024; }
  static_assert(BN % 64 == 0, "64-column boxes of the output");
};

template <int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
affine_gemm_tma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_y, const float* __restrict__ a1,
                const float* __restrict__ b1, const float* __restrict__ a2,
                const float* __restrict__ b2, long long M, int K, int N, int n_tiles) {
  using Lay = TmaLayout<BN>;
  constexpr int S = Lay::S, ACC = Lay::ACC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t full = base + Lay::BAR_OFF, empty = full + 8 * S;

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128, warp = wtid / 32, lane = threadIdx.x % 32;
  const int k_tiles = (K + BK - 1) / BK;
  const long long tiles = (M + kTmaBM - 1) / kTmaBM * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA thread's and the A1/B1 warp's lanes
      mbar_init(empty + 8 * s, 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp < 2 && (warp == 1 || lane == 0)) {
      // warp 0's first thread: x's and w's k-tiles; warp 1: A1 and B1
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (int)(tile / n_tiles) * kTmaBM, n0 = (int)(tile % n_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int k0 = kt * BK;
          const uint32_t bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          if (warp == 0) {
            mbar_expect_tx(bar, kXTile + Lay::W_TILE);
            tma_load(base + Lay::X_OFF + stage * kXTile, &map_x, k0, m0, bar);
            tma_load(base + Lay::W_OFF + stage * Lay::W_TILE, &map_w, k0, n0, bar);
          } else {
            const int c = k0 + 2 * lane;  // K is a multiple of 8: c, c + 1 both in or both past K
            float2 va = make_float2(0.f, 0.f), vb = va;
            if (c < K) {
              va = __ldg(reinterpret_cast<const float2*>(a1 + c));
              vb = __ldg(reinterpret_cast<const float2*>(b1 + c));
            }
            float* ab = reinterpret_cast<float*>(smem + Lay::AB_OFF + stage * 2 * BK * 4);
            *reinterpret_cast<float2*>(ab + 2 * lane) = make_float2(round_bf16(va.x), round_bf16(va.y));
            *reinterpret_cast<float2*>(ab + BK + 2 * lane) = make_float2(round_bf16(vb.x), round_bf16(vb.y));
            mbar_arrive(bar);  // releases this lane's stores to the consumers
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = wg * 64 + warp * 16;  // this warp's 16 rows of the tile
    const uint32_t out = base + Lay::OUT_OFF + wg * Lay::OUT_WG;
    const bool epi = a2 != nullptr;
    const int n_pad = n_tiles * BN;
    float* const e_a = reinterpret_cast<float*>(smem + Lay::EPI_OFF);
    if (epi) {  // A2 and B2 of every column, rounded to bf16, zero past N
      for (int c = threadIdx.x; c < n_pad; c += 256) {
        e_a[c] = c < N ? round_bf16(__ldg(a2 + c)) : 0.f;
        e_a[n_pad + c] = c < N ? round_bf16(__ldg(b2 + c)) : 0.f;
      }
      named_sync(3, 256);
    }
    int stage = 0;
    uint32_t phase = 0;
    float acc[ACC];

    // k-tile kt through the prologue into this warp's fragments (channels
    // past K have A1 = B1 = 0: they give relu(0) = 0, meeting w's zero
    // fill), then its products started
    auto run = [&](int kt, uint32_t (&a)[BK / 16][4]) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t xs = base + Lay::X_OFF + stage * kXTile;
      const float* ab = reinterpret_cast<const float*>(smem + Lay::AB_OFF + stage * 2 * BK * 4);
      uint32_t r[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        ldmatrix_x4(r[ks], xs + swz(row0 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const float2 alo = *reinterpret_cast<const float2*>(ab + ks * 16 + 2 * t4);
        const float2 ahi = *reinterpret_cast<const float2*>(ab + ks * 16 + 8 + 2 * t4);
        const float2 blo = *reinterpret_cast<const float2*>(ab + BK + ks * 16 + 2 * t4);
        const float2 bhi = *reinterpret_cast<const float2*>(ab + BK + ks * 16 + 8 + 2 * t4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 pa = q < 2 ? alo : ahi, pb = q < 2 ? blo : bhi;
          a[ks][q] = pack_relu(fmaf(bf16_lo(r[ks][q]), pa.x, pb.x), fmaf(bf16_hi(r[ks][q]), pa.y, pb.y));
        }
      }
      const int klim = K - kt * BK;
      const uint32_t ws = base + Lay::W_OFF + stage * Lay::W_TILE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        if (ks * 16 < klim) wgmma<BN>(acc, a[ks], sw128_desc(ws + ks * 32));
      wgmma_commit();
    };
    auto advance = [&]() {
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty + 8 * s);
    };

    uint32_t fa[BK / 16][4], fb[BK / 16][4];  // two k-tiles' fragments
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (int)(tile / n_tiles) * kTmaBM, n0 = (int)(tile % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      // k-tile kt's products run while k-tile kt + 1 goes through the
      // prologue; a stage is released once its products have read it
      int kt = 0, prev = -1;
      while (kt < k_tiles) {
        run(kt, fa);
        if (prev >= 0) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          release(prev);
        }
        prev = stage;
        advance();
        if (++kt == k_tiles) break;
        run(kt, fb);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        release(prev);
        prev = stage;
        advance();
        ++kt;
      }
      wgmma_wait0();
      release(prev);

      // the epilogue: each sum rounded to bf16, the optional affine+ReLU,
      // bf16 pairs into this warpgroup's staged boxes (64 rows x 64 columns,
      // 128-byte swizzled), then one TMA store a box, clipped at M and N
      if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg, 128);  // the previous tile's stores have read the boxes
#pragma unroll
      for (int i = 0; i < ACC; i += 2) {
        const int c = 8 * (i / 4) + 2 * t4;  // column in the tile
        uint32_t v = pack_bf16(acc[i], acc[i + 1]);
        if (epi) {
          const float2 ea = *reinterpret_cast<const float2*>(e_a + n0 + c);
          const float2 eb = *reinterpret_cast<const float2*>(e_a + n_pad + n0 + c);
          v = pack_relu(fmaf(bf16_lo(v), ea.x, eb.x), fmaf(bf16_hi(v), ea.y, eb.y));
        }
        const int r = warp * 16 + g + 8 * (i / 2 % 2);
        *reinterpret_cast<uint32_t*>(smem + (out - base) + (c / 64) * 64 * 128 + swz(r, c % 64 / 8) +
                                     4 * t4) = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (wtid == 0 && m0 + wg * 64 < M) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (n0 + j * 64 < N) tma_store(&map_y, out + j * 64 * 128, n0 + j * 64, m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// the runtime's entry-point query finds it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a bf16 (outer, inner) matrix of rows `row_bytes` apart, read and written in
// boxes of (box_outer, box_inner) with the 128-byte swizzle; zero fill past
// its edges
bool tensor_map(CUtensorMap* map, const void* ptr, long long outer, int inner,
                long long row_bytes, int box_outer, int box_inner) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The output tile's width: N up to 256 in one tile, wider N in tiles of 192
int tile_n(int N) { return N <= 128 ? 128 : N <= 192 || N > 256 ? 192 : 256; }

long long tma_blocks(long long M, int N) {
  const long long tiles = (M + kTmaBM - 1) / kTmaBM * ((N + tile_n(N) - 1) / tile_n(N));
  return tiles < hdu::sm_count() ? tiles : hdu::sm_count();  // persistent: one block an SM
}

template <int BN>
int launch_tma(const void* x, long long ld, const void* w, const float* a1, const float* b1,
               const float* a2, const float* b2, void* y, long long M, int K, int N,
               cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN;
  const int smem = TmaLayout<BN>::bytes(a2 != nullptr ? n_tiles * BN : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool opted[hdu::kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= hdu::kMaxDevices || !opted[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(affine_gemm_tma<BN>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    if (dev >= 0 && dev < hdu::kMaxDevices) opted[dev] = true;
  }
  // The inner extent of x's map is K, never ld: its zero fill past K meets
  // w's, and the buffer's channels [K, ld) are never read.
  CUtensorMap mx, mw, my;
  if (!tensor_map(&mx, x, M, K, ld * 2, kTmaBM, BK) || !tensor_map(&mw, w, N, K, (long long)K * 2, BN, BK) ||
      !tensor_map(&my, y, M, N, (long long)N * 2, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tma_blocks(M, N));
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, affine_gemm_tma<BN>, mx, mw, my, a1, b1, a2, b2, M,
                                            K, N, n_tiles);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = [epilogue] ( prologue(x (M, K), row stride ld) @ w (N, K)^T ).
// dtype 0: float32, 1: bfloat16. a2 == nullptr: no epilogue (b2 unread).
// bfloat16 takes K and N multiples of 8, ld a multiple of 8 and x, w, y
// 16-byte aligned, as the wrapper checks; a1, b1 8-byte aligned. With an
// epilogue, A2 and B2 of every column are staged: N up to 1,920.
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
  switch (tile_n(N)) {
    case 128: return launch_tma<128>(x, ld, w, a1, b1, a2, b2, y, M, K, N, s);
    case 256: return launch_tma<256>(x, ld, w, a1, b1, a2, b2, y, M, K, N, s);
    default: return launch_tma<192>(x, ld, w, a1, b1, a2, b2, y, M, K, N, s);
  }
}

// The form hdu_affine_gemm launches for (M, N, dtype): *bn the output
// tile's width (0: the float32 tiling) and *blocks the grid.
void hdu_affine_gemm_form(long long M, int N, int dtype, int* bn, long long* blocks) {
  *bn = dtype == 0 ? 0 : tile_n(N);
  *blocks = dtype == 0 ? (M + FB - 1) / FB * ((N + FB - 1) / FB) : tma_blocks(M, N);
}

}  // extern "C"
