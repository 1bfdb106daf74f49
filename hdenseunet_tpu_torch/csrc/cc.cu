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
// The labelling core of K4a-c is union-find in two levels: block-local
// labelling in shared memory after Playne & Hawick ("A New Algorithm for
// Parallel Connected-Component Labelling on GPUs", TPDS 2018), with the
// hooking and intermediate pointer jumping of ECL-CC (Jaiganesh & Burtscher,
// HPG 2018). A hook sets the larger of two roots to the smaller with
// atomicCAS, retried until the roots agree, so every parent is below its
// child and a root is the smallest index of its tree. The volume is cut
// into bricks of kBrickX x kBrickY x kBrickZ voxels, z fastest; the bricks
// at the volume's far ends are cut short. A brick row (64 z voxels) is one
// 64-bit word of set bits. Launches:
//   brick   one block a brick: the mask in as bits (a 16-byte load a lane,
//           four lanes' shuffles a row's word); a brick wholly outside or
//           inside the set is written out at once; otherwise every in-set
//           voxel points at the start of its z-run in the brick row, runs
//           of neighbouring rows hook in shared memory, and every voxel
//           finds its local root. Raster order inside a brick is the global
//           order, so a local root is the smallest flat index of its piece,
//           and label[i] = that flat index (kSent, INT32_MAX, outside the
//           set: JAX's _SENT). K4b and K4c also reduce each piece's voxel
//           count or border flag in shared memory and write it to the
//           local root's slot (only roots' slots are ever read, so nothing
//           is zeroed), and list the local roots' flat indices (one
//           atomicAdd a block on a counter in the stream's scratch);
//   merge   only voxels on a brick face whose preceding neighbour (13 of the
//           26-neighbourhood, 3 of the 6-cross) lies in another brick hook
//           in global memory (bricks the brick pass found outside the set
//           return at once): a walk goes voxel -> local root -> a short
//           chain of brick roots;
//   roots   (K4b, K4c) over the listed local roots only: each adds its count
//           into its global root (one integer atomicAdd per group of lanes
//           of a warp that share a root) and keeps the largest component
//           with one 64-bit key (size << 32 | N-1-root) under atomicMax, or
//           ORs its border flag into its global root; then points at it;
//   finish  K4a: label[i] = the root, the component minimum; K4b: mask &
//           (root == the best key's); K4c: mask | !flag[root]. Each voxel's
//           walk is one or two loads after the roots pass.
// Hooking a neighbour w = v + d off the z axis is needed only where the
// pair one z lower, (v - ez, w - ez), is not in the set: otherwise v and w
// join through it, since every z edge is kept (the runs inside a brick,
// hooks across its z faces). So a row hooks a neighbouring row once at the
// start of each segment where both are set, and most face voxels skip.
// What bounds it: bytes, about 10 a voxel (mask in, int32 label out and
// back, the output), and the brick's shared-memory walks; the roots pass
// and the merge touch a small share of the voxels.
//
// K4b largest_component: the largest 26-connected component; the largest
// size, on a tie the smallest root, which is scipy's argmax(bincount). The
// count that reaches a root's final size carries it (a partial count is
// never larger), so the maximum key is the winner's. No float, so the
// result is the same on every run.
//
// K4c fill_holes: the background labelled 6-connected; a component is a
// hole unless one of its voxels lies on the array border. The same
// function as JAX's +N seed offset.
//
// K4d compose_prep: the packed scores {0,1,3} to liver-or-tumour and tumour,
// zero in the xy compute padding, and the external mask's z-packed bits
// (np.packbits order, most significant bit first) to one cross dilation of
// the padded mask, eight voxels (one ext byte) per thread. compose_finish:
// the {0,1,2} labelmap, its 2-bit wire (4 z voxels per byte, _pack2bits) and
// its nonzero bbox in one launch. What bounds it: bytes, 3.25 a voxel (two
// masks in, labels and wire out). Its first form, one 4-voxel quad a
// thread and a block for every 1024 voxels, ran at a fifth of that bound:
// each of its ~29 k blocks at 512x512x112 ran six block-wide reductions,
// up to six atomicMax on the same six words and a ticket, all serialised
// in L2. Now a grid of as many blocks as the card holds at once strides over the
// volume in 16-voxel chunks, the bbox grows in registers, and each block
// adds it to six accumulators in the stream's scratch counters after one
// warp-shuffle reduction (at most six atomicMax and one ticket a block);
// the last block to arrive (common.cuh) writes the bbox and sets the
// counters back to zero. An empty map gives lo = the axis length > hi =
// -1, as _bbox_finish.
//
// Each launch goes on the caller's stream, allocates nothing and the entry
// points return cudaGetLastError(); the Python wrapper raises on a non-zero
// code.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSent = INT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBboxSlot = hdu::kTicketSlots;  // six accumulators, then the ticket
constexpr int kBboxTicket = hdu::kTicketSlots + 6;
constexpr int kRootCount = hdu::kTicketSlots + 7;  // local roots listed by the brick pass

// The brick (ops/cc.py's BRICK). kBrickZ is one 64-bit word of mask bits.
constexpr int kBrickX = 8, kBrickY = 16, kBrickZ = 64;
constexpr int kBrickRows = kBrickX * kBrickY;
constexpr int kBrickVoxels = kBrickRows * kBrickZ;
constexpr int kBrickThreads = 512;
constexpr int kChunk = kBrickVoxels / kBrickThreads;  // a thread's run of z voxels in one row
constexpr int kChunksPerRow = kBrickZ / kChunk;
static_assert(kBrickZ == 64 && kChunk == 16 && kChunksPerRow == 4, "four lanes a brick row");
static_assert(kBrickVoxels < 0xffff, "16-bit local indices");

// The neighbours before a voxel in raster order: the three of the 6-cross
// first (z, y, x), then the other ten of the 26-neighbourhood. (dx, dy, dz).
__constant__ int8_t kPrev[13][3] = {
    {0, 0, -1},  {0, -1, 0},   {-1, 0, 0},  {0, -1, -1}, {0, -1, 1},
    {-1, -1, 0}, {-1, 1, 0},   {-1, 0, -1}, {-1, 0, 1},  {-1, -1, -1},
    {-1, -1, 1}, {-1, 1, -1},  {-1, 1, 1}};

struct Geo {
  int X, Y, Z, n;
  int bx, by, bz, bricks;  // bricks along each axis, in all
  bool vec;  // 16-byte mask loads and label stores of whole chunks (Z % 16 == 0, aligned)
};

__device__ __forceinline__ bool in_set(const uint8_t* mask, int i, bool inv) {
  return (mask[i] != 0) != inv;
}

// The root of i; every voxel on the walk is pointed at its grandparent
// (intermediate pointer jumping). Only non-roots are written, and only
// with an ancestor. T: int flat indices in global memory, or uint16_t
// brick-local indices in shared memory.
template <typename T>
__device__ __forceinline__ int find(T* parent, int i) {
  int cur = parent[i];
  if (cur != i) {
    int prev = i, next;
    while (cur > (next = parent[cur])) {
      parent[prev] = (T)next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// The root of i, without writes: where a pass writes final roots, a pointer
// jump by another thread must not overwrite one with a mere ancestor.
template <typename T>
__device__ __forceinline__ int root_of(const T* parent, int i) {
  int cur = i, next;
  while (cur > (next = parent[cur])) cur = next;
  return cur;
}

// Join the trees of a and b: the larger root is set to the smaller.
template <typename T>
__device__ __forceinline__ void unite(T* parent, int a, int b) {
  a = find(parent, a);
  b = find(parent, b);
  while (a != b) {
    if (a < b) {
      const int ret = atomicCAS(&parent[b], (T)b, (T)a);
      if (ret == b) break;
      b = ret;
    } else {
      const int ret = atomicCAS(&parent[a], (T)a, (T)b);
      if (ret == a) break;
      a = ret;
    }
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

enum Mode { kPlain = 0, kCount = 1, kBorderFlag = 2 };

// Flat index of brick-local voxel l (row (lx, ly) = l / kBrickZ, lz = l %
// kBrickZ) of the brick at (x0, y0, z0), or -1 outside the array.
__device__ __forceinline__ int brick_flat(int l, int x0, int y0, int z0, const Geo& g) {
  const int row = l / kBrickZ;
  const int x = x0 + row / kBrickY, y = y0 + row % kBrickY, z = z0 + l % kBrickZ;
  return x < g.X && y < g.Y && z < g.Z ? (x * g.Y + y) * g.Z + z : -1;
}

// Four bits, one a byte of w: set where the byte is not zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (unsigned)((w & 0xffu) != 0u) | (unsigned)((w & 0xff00u) != 0u) << 1 |
         (unsigned)((w & 0xff0000u) != 0u) << 2 | (unsigned)((w >> 24) != 0u) << 3;
}

// label[i .. i + n) = v[0 .. n), four at a time: one 16-byte store when the
// whole group lies in the array and may be stored as a vector.
__device__ __forceinline__ void store4(int* label, int i, int n, bool vec, const int (&v)[4]) {
  if (vec && n >= 4) {
    *reinterpret_cast<int4*>(label + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) label[i + j] = v[j];
  }
}

// One block a brick; thread t owns a chunk of kChunk z voxels of one brick
// row (kChunksPerRow lanes a row). label[i] = the flat index of i's local
// root (kSent outside the set). kCount: slot_i32[root] = the piece's voxel
// count; kBorderFlag: slot_u8[root] = 1 if the piece touches the array
// border; both list the local roots in roots[], counted at
// counters[kRootCount]. Shared memory: the brick's parents as 16-bit local
// indices, its rows of set bits, and the tally (kCount: two 16-bit counts a
// word; kBorderFlag: a flag bit a voxel): at most 33 KB.
template <int NB, int MODE>
__global__ void __launch_bounds__(kBrickThreads, 2)
cc_brick(const uint8_t* __restrict__ mask, int* __restrict__ label, uint8_t* __restrict__ filled,
         Geo g, bool inv, int* __restrict__ slot_i32, uint8_t* __restrict__ slot_u8, int* __restrict__ roots,
         unsigned int* __restrict__ counters, unsigned long long* __restrict__ best) {
  constexpr uint16_t kNone = 0xffff;  // outside the set
  constexpr int kTally = MODE == kCount ? kBrickVoxels / 2 : MODE == kBorderFlag ? kBrickVoxels / 32 : 1;
  __shared__ uint16_t parent[kBrickVoxels];
  __shared__ unsigned long long rows[kBrickRows];
  __shared__ unsigned int tally[kTally];
  __shared__ int n_local, base, next;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int z0 = (b % g.bz) * kBrickZ;
  const int y0 = (b / g.bz % g.by) * kBrickY;
  const int x0 = (b / g.bz / g.by) * kBrickX;
  if (MODE == kCount && b == 0 && tid == 0) *best = 0ull;
  if (tid == 0) n_local = next = 0;
  const int row = tid / kChunksPerRow, zc = tid % kChunksPerRow * kChunk;
  const int x = x0 + row / kBrickY, y = y0 + row % kBrickY;
  const int lbase = row * kBrickZ + zc;  // local index of the chunk's first voxel
  // voxels of the chunk inside the array, and the flat index of its first
  const int nz = x < g.X && y < g.Y ? max(0, min(kChunk, g.Z - z0 - zc)) : 0;
  const int gbase = nz > 0 ? (x * g.Y + y) * g.Z + z0 + zc : 0;
  const bool vec = g.vec && nz == kChunk;

  // the chunk's set bits; the lanes of a row gather its 64-bit word
  unsigned bits = 0u;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + gbase);
    bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
           nonzero_bytes(v.w) << 12;
  } else {
    for (int j = 0; j < nz; ++j) bits |= (unsigned)(mask[gbase + j] != 0) << j;
  }
  const unsigned inside = nz == kChunk ? 0xffffu : (1u << nz) - 1u;
  if (inv) bits = ~bits & inside;
  unsigned long long m = (unsigned long long)bits << zc;
  m |= __shfl_xor_sync(0xffffffffu, m, 1);
  m |= __shfl_xor_sync(0xffffffffu, m, 2);  // the whole row's word, in each of its lanes
  if (tid % kChunksPerRow == 0) rows[row] = m;
  // a brick outside the set, or inside it (one piece, its root the brick's
  // first voxel), is written out at once
  const bool some = __syncthreads_or(bits != 0u);
  const bool every = __syncthreads_and(bits == inside);
  if (tid == 0) filled[b] = some;  // the merge skips bricks outside the set
  if (!some || every) {
    const int first = brick_flat(0, x0, y0, z0, g);
    const int v = some ? first : kSent;
    const int fill[4] = {v, v, v, v};
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) store4(label, gbase + q, nz - q, vec, fill);
    if (MODE == kPlain || !some || tid != 0) return;
    const int ex = min(kBrickX, g.X - x0), ey = min(kBrickY, g.Y - y0), ez = min(kBrickZ, g.Z - z0);
    if (MODE == kCount)
      slot_i32[first] = ex * ey * ez;
    else
      slot_u8[first] = x0 == 0 || y0 == 0 || z0 == 0 || x0 + ex == g.X || y0 + ey == g.Y ||
                       z0 + ez == g.Z;
    roots[atomicAdd(&counters[kRootCount], 1u)] = first;
    return;
  }

  // every in-set voxel points at the start of its z-run in the row, a root
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int z = zc + j;
    const unsigned long long below = ~m & ((1ull << z) - 1ull);  // unset bits under z
    parent[lbase + j] =
        (m >> z) & 1ull ? (uint16_t)(row * kBrickZ + (below ? 64 - __clzll((long long)below) : 0)) : kNone;
  }
  for (int j = tid; j < kTally; j += kBrickThreads) tally[j] = 0u;
  __syncthreads();

  // hooks between rows: for each row and each preceding offset off the z
  // axis whose row lies in the brick, the first voxel of every segment where
  // the voxel and its neighbour are both set (the segment rule, above)
  constexpr int kOff = NB - 1;  // kPrev[1..NB), the same for a whole warp
  for (int item = tid; item < kBrickRows * kOff; item += kBrickThreads) {
    const int r = item % kBrickRows, k = 1 + item / kBrickRows;
    const int nx = r / kBrickY + kPrev[k][0], ny = r % kBrickY + kPrev[k][1];
    if (nx < 0 || ny < 0 || ny >= kBrickY) continue;
    const int nrow = nx * kBrickY + ny, dz = kPrev[k][2];
    const unsigned long long mn = rows[nrow];
    const unsigned long long both = rows[r] & (dz == 0 ? mn : dz < 0 ? mn << 1 : mn >> 1);
    for (unsigned long long s = both & ~(both << 1); s != 0ull; s &= s - 1ull) {
      const int z = __ffsll((long long)s) - 1;
      unite(parent, r * kBrickZ + z, nrow * kBrickZ + z + dz);
    }
  }
  __syncthreads();

  // run starts point at their roots; then each voxel's root is two loads
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int z = zc + j;
    if (((m >> z) & 1ull) && (z == 0 || !((m >> (z - 1)) & 1ull)))
      parent[lbase + j] = (uint16_t)root_of(parent, lbase + j);
  }
  __syncthreads();
  int mine = 0, run_root = -1, run = 0;  // local roots here; the count of run_root so far
  const bool edge = x == 0 || y == 0 || x == g.X - 1 || y == g.Y - 1;
#pragma unroll
  for (int q = 0; q < kChunk; q += 4) {
    int lab[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = lbase + q + j;
      const int p = parent[l];
      const int r = p == kNone ? -1 : parent[p];
      lab[j] = r < 0 ? kSent : brick_flat(r, x0, y0, z0, g);
      mine += r == l;
      if (MODE == kCount && r != run_root) {  // each piece's count at its local root
        if (run_root >= 0) atomicAdd(&tally[run_root >> 1], (unsigned)run << (16 * (run_root & 1)));
        run_root = r;
        run = 0;
      }
      run += 1;
      const int z = z0 + zc + q + j;
      if (MODE == kBorderFlag && r >= 0 && (edge || z == 0 || z == g.Z - 1))  // or its border flag
        atomicOr(&tally[r >> 5], 1u << (r & 31));
    }
    store4(label, gbase + q, nz - q, vec, lab);
  }
  if (MODE == kPlain) return;
  if (MODE == kCount && run_root >= 0)
    atomicAdd(&tally[run_root >> 1], (unsigned)run << (16 * (run_root & 1)));

  // the slots of the local roots, and the roots listed
  if (mine != 0) atomicAdd(&n_local, mine);
  __syncthreads();
  if (tid == 0) base = (int)atomicAdd(&counters[kRootCount], (unsigned)n_local);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int l = lbase + j;
    if (parent[l] != l) continue;  // not a root, or outside the set
    if (MODE == kCount)
      slot_i32[gbase + j] = (int)((tally[l >> 1] >> (16 * (l & 1))) & 0xffffu);
    else
      slot_u8[gbase + j] = (uint8_t)((tally[l >> 5] >> (l & 31)) & 1u);
    roots[base + atomicAdd(&next, 1)] = gbase + j;
  }
}

// Voxels on a brick face, by face: x low, y low, z low (all), y high, z high
// (26-connected only: the 6-cross has no preceding neighbour there).
template <int NB>
struct Faces {
  static constexpr int kX = kBrickY * kBrickZ, kY = kBrickX * kBrickZ, kZ = kBrickX * kBrickY;
  static constexpr int kAll = NB == 13 ? kX + 2 * kY + 2 * kZ : kX + kY + kZ;
};

// Voxel q of the brick's faces hooks each preceding neighbour in another
// brick whose crossing this face owns (the first of x low, y low, z low,
// y high, z high that it crosses), under the segment rule.
// Grid: (bricks, the brick's face voxels / kThreads).
template <int NB>
__global__ void cc_merge(const uint8_t* __restrict__ mask, int* label,
                         const uint8_t* __restrict__ filled, Geo g, bool inv) {
  using F = Faces<NB>;
  const int b = blockIdx.x;
  if (!filled[b]) return;
  int q = blockIdx.y * kThreads + threadIdx.x, face, lx, ly, lz;
  if (q >= F::kAll) return;
  if (q < F::kX) {
    face = 0, lx = 0, ly = q / kBrickZ, lz = q % kBrickZ;
  } else if ((q -= F::kX) < F::kY) {
    face = 1, lx = q / kBrickZ, ly = 0, lz = q % kBrickZ;
  } else if ((q -= F::kY) < F::kZ) {
    face = 2, lx = q / kBrickY, ly = q % kBrickY, lz = 0;
  } else if ((q -= F::kZ) < F::kY) {
    face = 3, lx = q / kBrickZ, ly = kBrickY - 1, lz = q % kBrickZ;
  } else {
    q -= F::kY;
    face = 4, lx = q / kBrickY, ly = q % kBrickY, lz = kBrickZ - 1;
  }
  const int x = (b / g.bz / g.by) * kBrickX + lx;
  const int y = (b / g.bz % g.by) * kBrickY + ly;
  const int z = (b % g.bz) * kBrickZ + lz;
  if (x >= g.X || y >= g.Y || z >= g.Z) return;
  const int i = (x * g.Y + y) * g.Z + z;
  if (!in_set(mask, i, inv)) return;
  // first every load (the neighbour w and w - ez for each owned offset),
  // independent of each other, then the hooks
  int nb[NB];
  bool on[NB], on_below[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int dx = kPrev[k][0], dy = kPrev[k][1], dz = kPrev[k][2];
    const int owner = lx + dx < 0            ? 0
                      : ly + dy < 0          ? 1
                      : lz + dz < 0          ? 2
                      : ly + dy >= kBrickY   ? 3
                      : lz + dz >= kBrickZ   ? 4
                                             : -1;
    const int nx = x + dx, ny = y + dy, nz = z + dz;
    const bool ok = owner == face && nx >= 0 && ny >= 0 && nz >= 0 && ny < g.Y && nz < g.Z;
    nb[k] = (nx * g.Y + ny) * g.Z + nz;
    on[k] = ok && in_set(mask, nb[k], inv);
    on_below[k] = ok && k != 0 && nz > 0 && in_set(mask, nb[k] - 1, inv);
  }
  const bool below = z > 0 && in_set(mask, i - 1, inv);
#pragma unroll
  for (int k = 0; k < NB; ++k)
    if (on[k] && !(below && on_below[k])) unite(label, i, nb[k]);
}

// Over the listed local roots: each points at its global root and adds its
// count into it (kCount: the best key too) or ORs its flag into it. Whole
// warps step together, so lanes past the end meet the others in the match.
template <int MODE>
__global__ void cc_roots(int* label, const int* __restrict__ roots,
                         const unsigned int* __restrict__ counters, int n, int* sizes,
                         uint8_t* flags, unsigned long long* __restrict__ best) {
  const unsigned count = counters[kRootCount];
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned long long key = 0ull;
  for (long long at = warp * 32; at < count; at += stride) {
    int p = -1, r = -1;
    if (at + lane < count) {
      p = roots[at + lane];
      r = root_of(label, p);
    }
    if (MODE == kCount) {
      const int add = p >= 0 && p != r ? sizes[p] : 0;  // a global root's slot holds its own count
      const unsigned peers = __match_any_sync(0xffffffffu, r);
      int sum = 0;
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        const int v = __shfl_sync(0xffffffffu, add, src);
        if ((peers >> src) & 1u) sum += v;
      }
      if (r >= 0 && lane == __ffs(peers) - 1) {
        const int now = atomicAdd(&sizes[r], sum) + sum;
        key = max_u64(key, ((unsigned long long)now << 32) | (unsigned)(n - 1 - r));
      }
    } else if (p >= 0 && p != r && flags[p] != 0) {
      flags[r] = 1;
    }
    if (p != r) label[p] = r;
  }
  if (MODE == kCount) {
    key = block_max(key);
    if (threadIdx.x == 0 && key != 0ull) atomicMax(best, key);
  }
}

// Four voxels a thread. kPlain: label[i] = root; kCount: out = (root ==
// best's); kBorderFlag: out = outside the background, or a hole. With
// counters, sets the listed roots' count back to zero for the next call.
template <int MODE>
__global__ void cc_finish(int* label, const unsigned long long* __restrict__ best,
                          const uint8_t* __restrict__ flags, uint8_t* __restrict__ out, int n,
                          unsigned int* __restrict__ counters) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (counters != nullptr && t == 0) counters[kRootCount] = 0u;
  const long long i0 = 4 * t;
  if (i0 >= n) return;
  int pick = -1;
  if (MODE == kCount) {
    const unsigned long long key = *best;
    pick = key != 0ull ? n - 1 - (int)(unsigned)(key & 0xffffffffull) : -1;
  }
  const bool whole = i0 + 4 <= n;
  int lab[4];
  if (whole) {
    const int4 v = *reinterpret_cast<const int4*>(label + i0);
    lab[0] = v.x, lab[1] = v.y, lab[2] = v.z, lab[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) lab[k] = i0 + k < n ? label[i0 + k] : kSent;
  }
  unsigned res = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lab[k] == kSent ? -1 : root_of(label, lab[k]);
    if (MODE == kPlain)
      lab[k] = r < 0 ? kSent : r;
    else if (MODE == kCount)
      res |= (unsigned)(r >= 0 && r == pick) << (8 * k);
    else
      res |= (unsigned)(r < 0 || flags[r] == 0) << (8 * k);
  }
  if (MODE == kPlain) {
    if (whole) {
      *reinterpret_cast<int4*>(label + i0) = make_int4(lab[0], lab[1], lab[2], lab[3]);
    } else {
      for (int k = 0; i0 + k < n; ++k) label[i0 + k] = lab[k];
    }
  } else if (whole) {
    *reinterpret_cast<unsigned*>(out + i0) = res;
  } else {
    for (int k = 0; i0 + k < n; ++k) out[i0 + k] = (uint8_t)(res >> (8 * k));
  }
}

int blocks_for(long long work) { return (int)((work + kThreads - 1) / kThreads); }

template <int NB, int MODE>
int label_pass(const uint8_t* mask, int* label, uint8_t* filled, const Geo& g, bool inv, int* sizes,
               uint8_t* flags, int* roots, unsigned long long* best, uint8_t* out,
               unsigned int* counters, cudaStream_t s) {
  Geo gv = g;
  gv.vec = g.Z % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(label) % 16 == 0;
  cc_brick<NB, MODE><<<g.bricks, kBrickThreads, 0, s>>>(mask, label, filled, gv, inv, sizes, flags,
                                                         roots, counters, best);
  const dim3 faces(g.bricks, blocks_for(Faces<NB>::kAll));
  cc_merge<NB><<<faces, kThreads, 0, s>>>(mask, label, filled, g, inv);
  if (MODE != kPlain)
    cc_roots<MODE><<<4 * hdu::sm_count(), kThreads, 0, s>>>(label, roots, counters, g.n, sizes,
                                                              flags, best);
  cc_finish<MODE><<<blocks_for((g.n + 3LL) / 4), kThreads, 0, s>>>(
      label, best, flags, out, g.n, MODE == kPlain ? nullptr : counters);
  return (int)cudaGetLastError();
}

bool make_geo(int X, int Y, int Z, Geo& g) {
  const long long n = (long long)X * Y * Z;
  if (X <= 0 || Y <= 0 || Z <= 0 || n >= (long long)INT_MAX) return false;
  const int bx = (X + kBrickX - 1) / kBrickX, by = (Y + kBrickY - 1) / kBrickY,
            bz = (Z + kBrickZ - 1) / kBrickZ;
  g = Geo{X, Y, Z, (int)n, bx, by, bz, bx * by * bz, false};
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

// Labels of four voxels from their liver and tumour bytes (bit 0 of each
// byte): tumour 2 over liver 1 over background 0.
__device__ __forceinline__ unsigned labels4(unsigned lv, unsigned tv) {
  const unsigned t = tv & 0x01010101u;
  return (t << 1) | (lv & ~t & 0x01010101u);
}

// The 2-bit wire byte of four labels (_pack2bits: voxel k at bits 2k).
__device__ __forceinline__ unsigned pack4(unsigned lab) {
  return (lab & 0x3u) | ((lab >> 6) & 0xcu) | ((lab >> 12) & 0x30u) | ((lab >> 18) & 0xc0u);
}

// grow[k] (Xp - x_lo, x_hi + 1, Yp - y_lo, y_hi + 1, Z - z_lo, z_hi + 1)
// widened by the labelled voxels of one row: bits of zbits are z0, z0+1, ...
__device__ __forceinline__ void grow_row(unsigned (&grow)[6], int row, int z0, unsigned zbits,
                                         int Yp, int Xp, int Z) {
  const int x = row / Yp, y = row - x * Yp;
  const int lo = z0 + __ffs(zbits) - 1, hi = z0 + 31 - __clz(zbits);
  grow[0] = max(grow[0], (unsigned)(Xp - x));
  grow[1] = max(grow[1], (unsigned)(x + 1));
  grow[2] = max(grow[2], (unsigned)(Yp - y));
  grow[3] = max(grow[3], (unsigned)(y + 1));
  grow[4] = max(grow[4], (unsigned)(Z - lo));
  grow[5] = max(grow[5], (unsigned)(hi + 1));
}

// The {0,1,2} labelmap, its wire and its bbox. A grid of a few blocks an
// SM strides over the volume: chunks of 16 z voxels first (16-byte loads
// of liver and tumour, a 16-byte label store, a 4-byte wire store), then
// the last n % 16 voxels, or every voxel when a pointer is not 16-byte
// aligned (vec false), four at a time. The bbox grows in registers: a
// labelled chunk inside one row costs one division and a bit scan; one
// across rows (Z % 16 != 0) takes its four quads each in its own row. At
// the end one warp-shuffle reduction a block, at most six atomicMax and
// one ticket; the last block writes bbox and zeroes the counters.
__global__ void __launch_bounds__(kThreads)
compose_finish_kernel(const uint8_t* __restrict__ liver, const uint8_t* __restrict__ tumor,
                      uint8_t* __restrict__ labels, uint8_t* __restrict__ wire,
                      int* __restrict__ bbox, int Xp, int Yp, int Z, bool vec,
                      unsigned int* __restrict__ counters) {
  const int n = Xp * Yp * Z;
  const int Qz = Z / 4;  // wire bytes (quads) a row
  const int chunks = vec ? n / 16 : 0;
  const int quads = n / 4;
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  unsigned grow[6] = {0u, 0u, 0u, 0u, 0u, 0u};
  for (int c = tid; c < chunks; c += stride) {
    const uint4 lv = reinterpret_cast<const uint4*>(liver)[c];
    const uint4 tv = reinterpret_cast<const uint4*>(tumor)[c];
    const uint4 lab = make_uint4(labels4(lv.x, tv.x), labels4(lv.y, tv.y), labels4(lv.z, tv.z),
                                 labels4(lv.w, tv.w));
    reinterpret_cast<uint4*>(labels)[c] = lab;
    reinterpret_cast<unsigned*>(wire)[c] =
        pack4(lab.x) | pack4(lab.y) << 8 | pack4(lab.z) << 16 | pack4(lab.w) << 24;
    const unsigned m = nonzero_bytes(lab.x) | nonzero_bytes(lab.y) << 4 |
                       nonzero_bytes(lab.z) << 8 | nonzero_bytes(lab.w) << 12;
    if (m == 0u) continue;
    const int row = (16 * c) / Z, z0 = 16 * c - row * Z;
    if (z0 + 16 <= Z) {
      grow_row(grow, row, z0, m, Yp, Xp, Z);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned bits = (m >> (4 * j)) & 0xfu;
        const int q = 4 * c + j;
        const int r = q / Qz;
        if (bits != 0u) grow_row(grow, r, 4 * (q - r * Qz), bits, Yp, Xp, Z);
      }
    }
  }
  for (int q = 4 * chunks + tid; q < quads; q += stride) {
    const unsigned lab =
        labels4(reinterpret_cast<const unsigned*>(liver)[q], reinterpret_cast<const unsigned*>(tumor)[q]);
    reinterpret_cast<unsigned*>(labels)[q] = lab;
    wire[q] = (uint8_t)pack4(lab);
    const unsigned bits = nonzero_bytes(lab);
    const int r = q / Qz;
    if (bits != 0u) grow_row(grow, r, 4 * (q - r * Qz), bits, Yp, Xp, Z);
  }
  __shared__ unsigned warp_grow[kWarps][6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) grow[k] = max(grow[k], __shfl_xor_sync(0xffffffffu, grow[k], o));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) warp_grow[threadIdx.x >> 5][k] = grow[k];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    unsigned v = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = max(v, warp_grow[w][threadIdx.x]);
    if (v != 0u) atomicMax(&counters[kBboxSlot + threadIdx.x], v);
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
// index of each voxel's component, INT32_MAX outside the set; filled: one
// uint8 of work a brick (ops/cc.py's _bricks). conn 26 or 6; invert labels
// the complement of mask. Three launches.
extern "C" int hdu_cc_label(const uint8_t* mask, int* label, uint8_t* filled, int X, int Y, int Z,
                            int conn, int invert, void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g) || (conn != 26 && conn != 6)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = invert != 0;
  if (conn == 26)
    return label_pass<13, kPlain>(mask, label, filled, g, inv, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, s);
  return label_pass<3, kPlain>(mask, label, filled, g, inv, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, s);
}

// out: mask & (the largest 26-connected component, raster-first on a tie).
// Work: label and sizes (X, Y, Z) int32 (sizes is written and read at local
// roots only); roots int32, one per possible local root (ops/cc.py's
// _roots_capacity); filled as for hdu_cc_label; best one uint64; scratch
// hdu_scratch_bytes() bytes of the calling stream. Four launches.
extern "C" int hdu_cc_largest(const uint8_t* mask, int* label, int* sizes, int* roots,
                              uint8_t* filled, unsigned long long* best, uint8_t* out, int X,
                              int Y, int Z, void* scratch, void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  return label_pass<13, kCount>(mask, label, filled, g, false, sizes, nullptr, roots, best, out,
                                hdu::counters(scratch), static_cast<cudaStream_t>(stream));
}

// out: mask with every background component that does not touch the border
// (6-connected) filled. Work: label (X, Y, Z) int32, flags (X, Y, Z) uint8
// (written and read at local roots only), roots, filled and scratch as for
// hdu_cc_largest. Four launches.
extern "C" int hdu_cc_fill(const uint8_t* mask, int* label, uint8_t* flags, int* roots,
                           uint8_t* filled, uint8_t* out, int X, int Y, int Z, void* scratch,
                           void* stream) {
  Geo g;
  if (!make_geo(X, Y, Z, g) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  return label_pass<3, kBorderFlag>(mask, label, filled, g, true, nullptr, flags, roots, nullptr, out,
                                    hdu::counters(scratch), static_cast<cudaStream_t>(stream));
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

// liver, tumor: (Xp, Yp, Z) bool; labels: (Xp, Yp, Z) uint8 out {0,1,2};
// wire: (Xp, Yp, Z/4) uint8 out; bbox: 6 int32 out; scratch:
// hdu_scratch_bytes() bytes of the calling stream. Every pointer 4-byte
// aligned; 16-byte chunks where liver, tumor and labels are 16-byte
// aligned. One launch of as many blocks as the card holds at once.
extern "C" int hdu_compose_finish(const uint8_t* liver, const uint8_t* tumor, uint8_t* labels,
                                  uint8_t* wire, int* bbox, int Xp, int Yp, int Z,
                                  void* scratch, void* stream) {
  auto misaligned = [](const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a != 0; };
  if (Xp <= 0 || Yp <= 0 || Z <= 0 || Z % 4 != 0 || scratch == nullptr ||
      (long long)Xp * Yp * Z >= (long long)INT_MAX || misaligned(liver, 4) ||
      misaligned(tumor, 4) || misaligned(labels, 4) || misaligned(wire, 4))
    return (int)cudaErrorInvalidValue;
  const bool vec = !misaligned(liver, 16) && !misaligned(tumor, 16) && !misaligned(labels, 16);
  static int per_sm = 0;  // resident blocks an SM, the same on every device of one build
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compose_finish_kernel, kThreads, 0);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const long long work = vec ? (long long)Xp * Yp * Z / 16 + 3 : (long long)Xp * Yp * Z / 4;
  const int blocks = (int)std::min<long long>(blocks_for(work), (long long)per_sm * hdu::sm_count());
  compose_finish_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      liver, tumor, labels, wire, bbox, Xp, Yp, Z, vec, hdu::counters(scratch));
  return (int)cudaGetLastError();
}
