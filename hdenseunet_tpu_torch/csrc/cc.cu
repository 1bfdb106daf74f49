// K4: the device postprocess's connected components and compose passes, for sm_90a.
//
// Replaces the XLA programs of hdenseunet_tpu/infer/device_postprocess.py,
// which have no Pallas body: the min-label propagation (_one_iteration,
// _propagate_min, connected_min_labels), the largest-component pick
// (_largest_finish), the border-connected hole fill (_fill_seed,
// _fill_finish) and the compose's elementwise ends (_compose_prep with
// dilate_cross, the labelmap of compose_labels, _pack2bits, _bbox_finish).
// Every output is integer or boolean and bit-identical to the JAX program's.
//
// Volumes are C-contiguous (X, Y, Z), flat = (x*Y + y)*Z + z, z fastest: the
// raster order of scipy's ndimage.label, on which the tie rule rests.
//
// K4a cc_label: union-find after Playne & Hawick ("A New Algorithm for
// Parallel Connected-Component Labelling on GPUs", TPDS 2018), with the
// hooking and intermediate pointer jumping of ECL-CC (Jaiganesh & Burtscher,
// HPG 2018). Three launches:
//   init     label[i] = the first in-set neighbour that precedes i in raster
//            order (a parent below its child, so the forest has no cycle),
//            or i; outside the set kSent (INT32_MAX, JAX's _SENT);
//   merge    every in-set voxel hooks its other preceding in-set neighbours
//            (13 of the 26-neighbourhood, 3 of the 6-cross): the larger of
//            the two roots is set to the smaller with atomicCAS, retried
//            until the roots agree. A CAS changes only a root, so a root
//            ends at the smallest index of its component; `rep` shortens
//            the paths it walks with plain stores, which touch only
//            non-roots and only ever point a voxel at one of its ancestors;
//   compress label[i] = its root, the component minimum, after the merge
//            has finished (its own launch); its walks write nothing else,
//            so no final label is overwritten by an ancestor.
// What bounds it: the merge's dependent loads along the trees, not bytes
// (one mask byte in and one int32 label out per voxel).
//
// K4b largest_component: cc_label (26) whose compress also counts each
// component at its root with an integer atomicAdd, one per group of lanes of
// a warp that share a root (__match_any_sync), and keeps the largest with
// one 64-bit key (size << 32 | N-1-root) under atomicMax, one per block:
// the largest size, on a tie the smallest root, which is scipy's
// argmax(bincount). The count that reaches a root's final size carries it,
// so the maximum key is the winner's. A fourth launch writes
// mask & (label == best). No float, so the result is the same on every run.
//
// K4c fill_holes: cc_label (6) over the background; the compress flags the
// root of every background component that touches the array border; a fourth
// launch writes mask | (background & !flag[root]). The same function as JAX's
// +N seed offset.
//
// K4d compose_prep: the packed scores {0,1,3} to liver-or-tumour and tumour,
// zero in the xy compute padding, and the external mask's z-packed bits
// (np.packbits order, most significant bit first) to one cross dilation of
// the padded mask, eight voxels (one ext byte) per thread. compose_finish:
// the {0,1,2} labelmap, its 2-bit wire (4 z voxels per byte, _pack2bits) and
// its nonzero bbox in one launch: blocks reduce the bbox and add it to six
// accumulators in the stream's scratch counters with atomicMax; the last
// block to arrive (common.cuh) writes the bbox and sets the counters back to
// zero. An empty map gives lo = the axis length > hi = -1, as _bbox_finish.
//
// Each launch goes on the caller's stream, allocates nothing and the entry
// points return cudaGetLastError(); the Python wrapper raises on a non-zero
// code.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSent = INT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBboxSlot = hdu::kTicketSlots;  // six accumulators, then the ticket
constexpr int kBboxTicket = hdu::kTicketSlots + 6;

// The neighbours before a voxel in raster order: the three of the 6-cross
// first, then the other ten of the 26-neighbourhood. (dx, dy, dz).
__constant__ int8_t kPrev[13][3] = {
    {0, 0, -1},  {0, -1, 0},   {-1, 0, 0},  {0, -1, -1}, {0, -1, 1},
    {-1, -1, 0}, {-1, 1, 0},   {-1, 0, -1}, {-1, 0, 1},  {-1, -1, -1},
    {-1, -1, 1}, {-1, 1, -1},  {-1, 1, 1}};

struct Geo {
  int X, Y, Z, n;
};

__device__ __forceinline__ void coords(int i, const Geo& g, int& x, int& y, int& z) {
  z = i % g.Z;
  const int t = i / g.Z;
  y = t % g.Y;
  x = t / g.Y;
}

__device__ __forceinline__ bool in_set(const uint8_t* mask, int i, bool inv) {
  return (mask[i] != 0) != inv;
}

// Flat index of neighbour k of (x, y, z), or -1 outside the array (no wrap).
__device__ __forceinline__ int neighbour(int k, int x, int y, int z, const Geo& g) {
  const int nx = x + kPrev[k][0], ny = y + kPrev[k][1], nz = z + kPrev[k][2];
  if (nx < 0 || ny < 0 || nz < 0 || ny >= g.Y || nz >= g.Z) return -1;
  return (nx * g.Y + ny) * g.Z + nz;
}

// The root of i. Every voxel on the walk is pointed at its grandparent
// (intermediate pointer jumping); only non-roots are written.
__device__ __forceinline__ int rep(int* label, int i) {
  int cur = label[i];
  if (cur != i) {
    int prev = i, next;
    while (cur > (next = label[cur])) {
      label[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// The root of i, without writes: the compress writes each voxel's final
// label, and a pointer jump by another thread must not overwrite one with a
// mere ancestor.
__device__ __forceinline__ int root_of(const int* label, int i) {
  int cur = i, next;
  while (cur > (next = label[cur])) cur = next;
  return cur;
}

template <int NB>
__global__ void cc_init(const uint8_t* __restrict__ mask, int* __restrict__ label, Geo g,
                        bool inv, int* __restrict__ zero_i32, uint8_t* __restrict__ zero_u8,
                        unsigned long long* __restrict__ zero_key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  if (zero_i32 != nullptr) zero_i32[i] = 0;
  if (zero_u8 != nullptr) zero_u8[i] = 0;
  if (zero_key != nullptr && i == 0) *zero_key = 0ull;
  if (!in_set(mask, i, inv)) {
    label[i] = kSent;
    return;
  }
  int x, y, z;
  coords(i, g, x, y, z);
  int parent = i;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int j = neighbour(k, x, y, z, g);
    if (j >= 0 && in_set(mask, j, inv)) {
      parent = j;
      break;
    }
  }
  label[i] = parent;
}

template <int NB>
__global__ void cc_merge(const uint8_t* __restrict__ mask, int* label, Geo g, bool inv) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n || !in_set(mask, i, inv)) return;
  int x, y, z;
  coords(i, g, x, y, z);
  bool linked = false;  // the neighbour init linked i to needs no hook
  int v = -1;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int j = neighbour(k, x, y, z, g);
    if (j < 0 || !in_set(mask, j, inv)) continue;
    if (!linked) {
      linked = true;
      continue;
    }
    if (v < 0) v = rep(label, i);
    int o = rep(label, j);
    while (v != o) {  // hook the larger root under the smaller, until they agree
      if (v < o) {
        const int ret = atomicCAS(&label[o], o, v);
        if (ret == o) break;
        o = ret;
      } else {
        const int ret = atomicCAS(&label[v], v, o);
        if (ret == v) break;
        v = ret;
      }
    }
    v = v < o ? v : o;
  }
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// The maximum of v over the block, in thread 0.
__device__ __forceinline__ unsigned long long block_max(unsigned long long v) {
  __shared__ unsigned long long warp_max[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_u64(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? warp_max[threadIdx.x] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max_u64(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

enum CompressMode { kPlain = 0, kCount = 1, kBorderFlag = 2 };

// label[i] = root; with kCount also each component's size at its root and
// the best key; with kBorderFlag a flag on the root of each component that
// touches the border. No thread leaves early: whole warps and blocks meet in
// the reductions.
template <int MODE>
__global__ void cc_compress(const uint8_t* __restrict__ mask, int* label, Geo g, bool inv,
                            int* __restrict__ sizes, unsigned long long* __restrict__ best,
                            uint8_t* __restrict__ flags) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = i < g.n && in_set(mask, i, inv);
  int r = -1;
  if (ok) {
    r = root_of(label, i);
    label[i] = r;
  }
  if (MODE == kCount) {
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    unsigned long long key = 0ull;
    if (r >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
      const int add = __popc(peers);
      const int now = atomicAdd(&sizes[r], add) + add;
      key = ((unsigned long long)now << 32) | (unsigned)(g.n - 1 - r);
    }
    key = block_max(key);
    if (threadIdx.x == 0 && key != 0ull) atomicMax(best, key);
  }
  if (MODE == kBorderFlag && ok) {
    int x, y, z;
    coords(i, g, x, y, z);
    if (x == 0 || y == 0 || z == 0 || x == g.X - 1 || y == g.Y - 1 || z == g.Z - 1) flags[r] = 1;
  }
}

__global__ void largest_select(const int* __restrict__ label,
                               const unsigned long long* __restrict__ best,
                               uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = *best;
  const int root = key != 0ull ? n - 1 - (int)(unsigned)(key & 0xffffffffull) : -1;
  out[i] = label[i] == root ? 1 : 0;  // kSent outside the mask never equals a root
}

__global__ void fill_finish(const uint8_t* __restrict__ mask, const int* __restrict__ label,
                            const uint8_t* __restrict__ flags, uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = (mask[i] != 0 || flags[label[i]] == 0) ? 1 : 0;
}

int blocks_for(long long work) { return (int)((work + kThreads - 1) / kThreads); }

template <int NB>
int label_pass(const uint8_t* mask, int* label, Geo g, bool inv, int mode, int* sizes,
               unsigned long long* best, uint8_t* flags, cudaStream_t s) {
  const int blocks = blocks_for(g.n);
  cc_init<NB><<<blocks, kThreads, 0, s>>>(mask, label, g, inv, sizes, flags, best);
  cc_merge<NB><<<blocks, kThreads, 0, s>>>(mask, label, g, inv);
  if (mode == kCount)
    cc_compress<kCount><<<blocks, kThreads, 0, s>>>(mask, label, g, inv, sizes, best, flags);
  else if (mode == kBorderFlag)
    cc_compress<kBorderFlag><<<blocks, kThreads, 0, s>>>(mask, label, g, inv, sizes, best, flags);
  else
    cc_compress<kPlain><<<blocks, kThreads, 0, s>>>(mask, label, g, inv, sizes, best, flags);
  return (int)cudaGetLastError();
}

bool make_geo(int X, int Y, int Z, Geo& g) {
  const long long n = (long long)X * Y * Z;
  if (X <= 0 || Y <= 0 || Z <= 0 || n >= (long long)INT_MAX) return false;
  g = Geo{X, Y, Z, (int)n};
  return true;
}

// Eight z voxels of the padded, dilated external mask: thread (x, y, q)
// reads ext byte q of (x, y) and its six neighbours' bytes; bit 7 is z = 8q.
__global__ void compose_prep_kernel(const uint8_t* __restrict__ scores,
                                    const uint8_t* __restrict__ ext_bits,
                                    uint8_t* __restrict__ liver, uint8_t* __restrict__ tumor,
                                    uint8_t* __restrict__ ext, int Xp, int Yp, int Zs, int X0,
                                    int Y0, int pack_z) {
  const int Q = pack_z / 8;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)Xp * Yp * Q) return;
  const int q = (int)(t % Q);
  const int xy = (int)(t / Q);
  const int y = xy % Yp, x = xy / Yp;
  auto bits = [&](int xx, int yy, int qq) -> unsigned {
    if (xx < 0 || yy < 0 || qq < 0 || xx >= X0 || yy >= Y0 || qq >= Q) return 0u;
    return ext_bits[((long long)xx * Y0 + yy) * Q + qq];
  };
  const unsigned b = bits(x, y, q);
  const unsigned d = b | ((b << 1) & 0xffu) | (b >> 1) | ((bits(x, y, q - 1) & 1u) << 7) |
                     (bits(x, y, q + 1) >> 7) | bits(x - 1, y, q) | bits(x + 1, y, q) |
                     bits(x, y - 1, q) | bits(x, y + 1, q);
  const bool real = x < X0 && y < Y0;  // the xy compute padding holds phantom labels
  const uint8_t* m = scores + ((long long)x * Yp + y) * Zs + 8 * q;
  unsigned long long lv = 0ull, tv = 0ull, ev = 0ull;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned v = real ? m[k] : 0u;
    const unsigned long long is_tumor = v >= 3u;
    lv |= (((v & 1u) | is_tumor) & 1ull) << (8 * k);
    tv |= is_tumor << (8 * k);
    ev |= (unsigned long long)((d >> (7 - k)) & 1u) << (8 * k);
  }
  const long long off = ((long long)x * Yp + y) * pack_z + 8 * q;  // 8-byte aligned
  *reinterpret_cast<unsigned long long*>(liver + off) = lv;
  *reinterpret_cast<unsigned long long*>(tumor + off) = tv;
  *reinterpret_cast<unsigned long long*>(ext + off) = ev;
}

// Four z voxels per thread: byte t of the wire, labels 4t..4t+3.
__global__ void compose_finish_kernel(const uint8_t* __restrict__ liver,
                                      const uint8_t* __restrict__ tumor,
                                      uint8_t* __restrict__ labels, uint8_t* __restrict__ wire,
                                      int* __restrict__ bbox, int Xp, int Yp, int Z,
                                      unsigned int* __restrict__ counters) {
  const int Q = Z / 4;
  const long long total = (long long)Xp * Yp * Q;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  // grow[k]: Xp - x_lo, x_hi + 1, Yp - y_lo, y_hi + 1, Z - z_lo, z_hi + 1;
  // all 0 where nothing is labelled, and maxima combine them
  unsigned long long grow[6] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
  if (t < total) {
    const unsigned lv = *reinterpret_cast<const unsigned*>(liver + 4 * t);
    const unsigned tv = *reinterpret_cast<const unsigned*>(tumor + 4 * t);
    unsigned out = 0u, packed = 0u;
    int lo = 4, hi = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lab = ((tv >> (8 * k)) & 1u) ? 2u : ((lv >> (8 * k)) & 1u);
      out |= lab << (8 * k);
      packed |= lab << (2 * k);
      if (lab != 0u) {
        lo = lo < k ? lo : k;
        hi = k;
      }
    }
    *reinterpret_cast<unsigned*>(labels + 4 * t) = out;
    wire[t] = (uint8_t)packed;
    if (out != 0u) {
      const int q = (int)(t % Q);
      const int xy = (int)(t / Q);
      const int y = xy % Yp, x = xy / Yp;
      grow[0] = Xp - x;
      grow[1] = x + 1;
      grow[2] = Yp - y;
      grow[3] = y + 1;
      grow[4] = Z - (4 * q + lo);
      grow[5] = 4 * q + hi + 1;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const unsigned long long v = block_max(grow[k]);
    if (threadIdx.x == 0 && v != 0ull) atomicMax(&counters[kBboxSlot + k], (unsigned)v);
    __syncthreads();  // warp_max is reused by the next reduction
  }
  if (!hdu::arrive_last(&counters[kBboxTicket], gridDim.x)) return;
  if (threadIdx.x == 0) {
    const int axis[3] = {Xp, Yp, Z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned lo_grow = atomicExch(&counters[kBboxSlot + 2 * a], 0u);
      const unsigned hi_grow = atomicExch(&counters[kBboxSlot + 2 * a + 1], 0u);
      bbox[2 * a] = axis[a] - (int)lo_grow;
      bbox[2 * a + 1] = (int)hi_grow - 1;
    }
    counters[kBboxTicket] = 0u;
  }
}

}  // namespace

// mask: (X, Y, Z) bool/uint8; label: (X, Y, Z) int32 out, the smallest flat
// index of each voxel's component, INT32_MAX outside the set. conn 26 or 6;
// invert labels the complement of mask. Three launches.
extern "C" int hdu_cc_label(const uint8_t* mask, int* label, int X, int Y, int Z, int conn,
                            int invert, void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g) || (conn != 26 && conn != 6)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = invert != 0;
  if (conn == 26) return label_pass<13>(mask, label, g, inv, kPlain, nullptr, nullptr, nullptr, s);
  return label_pass<3>(mask, label, g, inv, kPlain, nullptr, nullptr, nullptr, s);
}

// out: mask & (label == the largest 26-connected component, raster-first on
// a tie); label, sizes: (X, Y, Z) int32 work; best: one uint64 of work.
// Four launches.
extern "C" int hdu_cc_largest(const uint8_t* mask, int* label, int* sizes,
                              unsigned long long* best, uint8_t* out, int X, int Y, int Z,
                              void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = label_pass<13>(mask, label, g, false, kCount, sizes, best, nullptr, s);
  if (rc != 0) return rc;
  largest_select<<<blocks_for(g.n), kThreads, 0, s>>>(label, best, out, g.n);
  return (int)cudaGetLastError();
}

// out: mask with every background component that does not touch the border
// (6-connected) filled; label: (X, Y, Z) int32 work, flags: (X, Y, Z) uint8
// work. Four launches.
extern "C" int hdu_cc_fill(const uint8_t* mask, int* label, uint8_t* flags, uint8_t* out,
                           int X, int Y, int Z, void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = label_pass<3>(mask, label, g, true, kBorderFlag, nullptr, nullptr, flags, s);
  if (rc != 0) return rc;
  fill_finish<<<blocks_for(g.n), kThreads, 0, s>>>(mask, label, flags, out, g.n);
  return (int)cudaGetLastError();
}

// scores: (Xp, Yp, Zs) uint8 {0,1,3}; ext_bits: (X0, Y0, pack_z/8) uint8;
// liver, tumor, ext: (Xp, Yp, pack_z) bool out, 8-byte aligned. One launch.
extern "C" int hdu_compose_prep(const uint8_t* scores, const uint8_t* ext_bits, uint8_t* liver,
                                uint8_t* tumor, uint8_t* ext, int Xp, int Yp, int Zs, int X0,
                                int Y0, int pack_z, void* stream) {
  if (Xp <= 0 || Yp <= 0 || X0 <= 0 || Y0 <= 0 || X0 > Xp || Y0 > Yp || pack_z <= 0 ||
      pack_z % 8 != 0 || pack_z > Zs || (long long)Xp * Yp * pack_z >= (long long)INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)Xp * Yp * (pack_z / 8);
  compose_prep_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, ext_bits, liver, tumor, ext, Xp, Yp, Zs, X0, Y0, pack_z);
  return (int)cudaGetLastError();
}

// liver, tumor: (Xp, Yp, Z) bool, 4-byte aligned; labels: (Xp, Yp, Z) uint8
// out {0,1,2}; wire: (Xp, Yp, Z/4) uint8 out; bbox: 6 int32 out; scratch:
// hdu_scratch_bytes() bytes of the calling stream. One launch.
extern "C" int hdu_compose_finish(const uint8_t* liver, const uint8_t* tumor, uint8_t* labels,
                                  uint8_t* wire, int* bbox, int Xp, int Yp, int Z,
                                  void* scratch, void* stream) {
  if (Xp <= 0 || Yp <= 0 || Z <= 0 || Z % 4 != 0 || scratch == nullptr ||
      (long long)Xp * Yp * Z >= (long long)INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)Xp * Yp * (Z / 4);
  compose_finish_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      liver, tumor, labels, wire, bbox, Xp, Yp, Z, hdu::counters(scratch));
  return (int)cudaGetLastError();
}
