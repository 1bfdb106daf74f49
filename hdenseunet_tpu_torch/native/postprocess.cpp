// Native host postprocess core: the reference's CC/morphology pipeline
// (test.py:70-115) as exact scipy-semantics passes in C++.
//
// Why this exists: the serving pipeline's host postprocess (infer/
// postprocess.py — scipy.ndimage label x2, binary_dilation, binary_fill_holes
// x3 on a 512x512x192 bool volume) measured 38-64 s per volume on the 1-core
// CI host and is the pipelined serving path's floor (BENCH_NOTES.md "Round-5
// serving-path attribution"). scipy's `binary_fill_holes` is the hot op: it
// flood-fills by ITERATED binary dilation (O(N * diameter) passes); the
// border-BFS below is O(N). `label` + bincount is replaced by one-pass
// union-find. Each function is byte-exact against its scipy twin
// (tests/test_native_postprocess.py), and infer/postprocess.py falls back to
// scipy when no toolchain is present.
//
// Layout: all masks are C-contiguous uint8 (X, Y, Z), flat = (x*Y + y)*Z + z
// — numpy's order, so raster scans here match scipy's label numbering.
//
// Semantics replicated exactly:
//  * largest_component: ndimage.label(structure=full 26-conn) then
//    sizes.argmax() with sizes[0]=0 — on ties scipy returns the SMALLEST
//    label id, i.e. the component first encountered in raster order; the
//    union-find below roots every component at its minimal flat index, so
//    picking (max size, then min root) reproduces the tie-break.
//  * fill_holes: binary_fill_holes default structure = 6-conn; holes are
//    complement voxels not 6-connected to the array border.
//  * dilate_extent: binary_dilation(iterations=1) default structure = 6-conn
//    cross (center included), computed over the mask's grown bounding box.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t uf_find(std::vector<int64_t>& parent, int64_t i) {
  int64_t root = i;
  while (parent[root] != root) root = parent[root];
  while (parent[i] != root) {  // path compression
    int64_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

// Union keeping the minimal flat index as root (first raster occurrence).
inline void uf_union(std::vector<int64_t>& parent, int64_t a, int64_t b) {
  a = uf_find(parent, a);
  b = uf_find(parent, b);
  if (a == b) return;
  if (a < b)
    parent[b] = a;
  else
    parent[a] = b;
}

}  // namespace

extern "C" {

// out := boolean mask of the largest 26-connected component of mask (uint8
// 0/1). Empty input -> all zeros. Exact ndimage.label(full)+argmax semantics.
void pp_largest_component(const uint8_t* mask, long X, long Y, long Z,
                          uint8_t* out) {
  const int64_t N = (int64_t)X * Y * Z;
  std::vector<int64_t> parent(N, -1);

  // 13 "previously visited in raster order" neighbor deltas for 26-conn.
  // Raster order is (x, y, z) lexicographic with z minor.
  struct D {
    int dx, dy, dz;
  };
  static const D deltas[13] = {
      {-1, -1, -1}, {-1, -1, 0}, {-1, -1, 1}, {-1, 0, -1}, {-1, 0, 0},
      {-1, 0, 1},   {-1, 1, -1}, {-1, 1, 0},  {-1, 1, 1},  {0, -1, -1},
      {0, -1, 0},   {0, -1, 1},  {0, 0, -1}};

  for (long x = 0; x < X; ++x) {
    for (long y = 0; y < Y; ++y) {
      const int64_t rowbase = ((int64_t)x * Y + y) * Z;
      for (long z = 0; z < Z; ++z) {
        const int64_t i = rowbase + z;
        if (!mask[i]) continue;
        parent[i] = i;
        for (const D& d : deltas) {
          const long nx = x + d.dx, ny = y + d.dy, nz = z + d.dz;
          if (nx < 0 || ny < 0 || nz < 0 || ny >= Y || nz >= Z) continue;
          const int64_t j = ((int64_t)nx * Y + ny) * Z + nz;
          if (parent[j] >= 0) uf_union(parent, i, j);
        }
      }
    }
  }

  // Component sizes keyed by root; best = (max size, min root).
  // Two passes keep it simple; sizes live in a flat map over roots only.
  std::vector<int64_t> size(N, 0);
  int64_t best_root = -1, best_size = 0;
  for (int64_t i = 0; i < N; ++i) {
    if (parent[i] < 0) continue;
    const int64_t r = uf_find(parent, i);
    if (++size[r] > best_size) {
      best_size = size[r];
      best_root = r;
    } else if (size[r] == best_size && r < best_root) {
      best_root = r;
    }
  }
  if (best_root < 0) {
    std::memset(out, 0, (size_t)N);
    return;
  }
  for (int64_t i = 0; i < N; ++i)
    out[i] = (parent[i] >= 0 && uf_find(parent, i) == best_root) ? 1 : 0;
}

// out := mask with holes filled: complement voxels NOT 6-connected to the
// border become foreground. Exact binary_fill_holes(default structure).
void pp_fill_holes(const uint8_t* mask, long X, long Y, long Z, uint8_t* out) {
  const int64_t N = (int64_t)X * Y * Z;
  // out doubles as the "border-reachable background" marker during the BFS:
  // 0 = unvisited, 2 = reached background. Rewritten to 0/1 at the end.
  std::memset(out, 0, (size_t)N);

  std::vector<int64_t> stack;
  stack.reserve(1 << 20);
  auto push = [&](int64_t i) {
    if (!mask[i] && !out[i]) {
      out[i] = 2;
      stack.push_back(i);
    }
  };

  // Seed: every background voxel on any face of the box.
  for (long x = 0; x < X; ++x)
    for (long y = 0; y < Y; ++y) {
      const int64_t base = ((int64_t)x * Y + y) * Z;
      if (x == 0 || x == X - 1 || y == 0 || y == Y - 1) {
        for (long z = 0; z < Z; ++z) push(base + z);
      } else {
        push(base);
        push(base + Z - 1);
      }
    }

  const int64_t sx = (int64_t)Y * Z, sy = Z;
  while (!stack.empty()) {
    const int64_t i = stack.back();
    stack.pop_back();
    const long x = (long)(i / sx), y = (long)((i / sy) % Y), z = (long)(i % Z);
    if (x > 0) push(i - sx);
    if (x < X - 1) push(i + sx);
    if (y > 0) push(i - sy);
    if (y < Y - 1) push(i + sy);
    if (z > 0) push(i - 1);
    if (z < Z - 1) push(i + 1);
  }

  for (int64_t i = 0; i < N; ++i) out[i] = mask[i] ? 1 : (out[i] ? 0 : 1);
}

// out := one 6-conn dilation of mask (binary_dilation default structure,
// iterations=1; structure includes the center; any nonzero byte is set) as
// 0/1 bytes, and box := the dilation's bounding box [x0, x1, y0, y1, z0,
// z1), half-open: the mask's nonzero box grown by one voxel, clipped to the
// volume. One read of the mask finds the box; the dilation then runs over
// the box alone, and out must hold zeros outside it on entry (the caller
// passes zeroed memory). A 6-conn dilation grows the nonzero z range by one
// slice at each end, so [z0, z1) is also the dilated mask's z extent. An
// empty mask leaves out and box all zero.
void pp_dilate_extent(const uint8_t* __restrict__ mask, long X, long Y, long Z,
                      uint8_t* __restrict__ out, long* box) {
  long xlo = X, xhi = -1, ylo = Y, yhi = -1, zlo = Z, zhi = -1;
  for (long x = 0; x < X; ++x)
    for (long y = 0; y < Y; ++y) {
      const uint8_t* row = mask + ((int64_t)x * Y + y) * Z;
      uint8_t any = 0;
      for (long z = 0; z < Z; ++z) any |= row[z];
      if (!any) continue;
      if (x < xlo) xlo = x;
      xhi = x;
      if (y < ylo) ylo = y;
      if (y > yhi) yhi = y;
      long z = 0;  // scans only below the lowest z found so far
      while (z < zlo && !row[z]) ++z;
      zlo = z < zlo ? z : zlo;
      z = Z - 1;  // and above the highest
      while (z > zhi && !row[z]) --z;
      zhi = z > zhi ? z : zhi;
    }
  for (int i = 0; i < 6; ++i) box[i] = 0;
  if (xhi < 0) return;
  const long x0 = xlo > 0 ? xlo - 1 : 0, x1 = xhi + 2 < X ? xhi + 2 : X;
  const long y0 = ylo > 0 ? ylo - 1 : 0, y1 = yhi + 2 < Y ? yhi + 2 : Y;
  const long z0 = zlo > 0 ? zlo - 1 : 0, z1 = zhi + 2 < Z ? zhi + 2 : Z;
  box[0] = x0, box[1] = x1, box[2] = y0, box[3] = y1, box[4] = z0, box[5] = z1;

  // A missing x or y neighbour row reads as zeros; the z ends are done once
  // a row, so the inner loop is branch-free.
  const std::vector<uint8_t> zero((size_t)Z, 0);
  const long za = z0 > 0 ? z0 : 1, zb = z1 < Z ? z1 : Z - 1;
  for (long x = x0; x < x1; ++x)
    for (long y = y0; y < y1; ++y) {
      const int64_t base = ((int64_t)x * Y + y) * Z;
      const uint8_t* __restrict__ c = mask + base;
      const uint8_t* __restrict__ xm = x > 0 ? c - (int64_t)Y * Z : zero.data();
      const uint8_t* __restrict__ xp = x < X - 1 ? c + (int64_t)Y * Z : zero.data();
      const uint8_t* __restrict__ ym = y > 0 ? c - Z : zero.data();
      const uint8_t* __restrict__ yp = y < Y - 1 ? c + Z : zero.data();
      uint8_t* __restrict__ o = out + base;
      for (long z = za; z < zb; ++z)
        o[z] = (c[z - 1] | c[z] | c[z + 1] | xm[z] | xp[z] | ym[z] | yp[z]) != 0;
      for (long z : {z0, z1 - 1}) {  // the box's z ends, where z +- 1 may leave the volume
        if (z >= za && z < zb) continue;
        const uint8_t lo = z > 0 ? c[z - 1] : 0, hi = z < Z - 1 ? c[z + 1] : 0;
        o[z] = (lo | c[z] | hi | xm[z] | xp[z] | ym[z] | yp[z]) != 0;
      }
    }
}

}  // extern "C"
