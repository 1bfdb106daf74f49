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
//  * binary_dilate: binary_dilation(iterations=1) default structure = 6-conn
//    cross (center included).

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
// iterations=1; structure includes the center).
void pp_dilate(const uint8_t* mask, long X, long Y, long Z, uint8_t* out) {
  const int64_t sx = (int64_t)Y * Z, sy = Z;
  for (long x = 0; x < X; ++x)
    for (long y = 0; y < Y; ++y) {
      const int64_t base = (int64_t)x * sx + (int64_t)y * sy;
      for (long z = 0; z < Z; ++z) {
        const int64_t i = base + z;
        uint8_t v = mask[i];
        if (!v && x > 0) v = mask[i - sx];
        if (!v && x < X - 1) v = mask[i + sx];
        if (!v && y > 0) v = mask[i - sy];
        if (!v && y < Y - 1) v = mask[i + sy];
        if (!v && z > 0) v = mask[i - 1];
        if (!v && z < Z - 1) v = mask[i + 1];
        out[i] = v ? 1 : 0;
      }
    }
}

}  // extern "C"
