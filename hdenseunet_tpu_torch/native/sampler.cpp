// Native data-loader core: fused crop + mean-subtract + flip/rot augment +
// per-slice resize (bicubic Catmull-Rom for images, nearest for labels).
//
// This is the training sampler's hot path (reference: per-crop python in
// train_2ddense.py:40-97 running under a 14-thread pool + 3 enqueuer
// processes). Here one C call replaces the numpy slice / np.flip / np.rot90 /
// skimage.resize chain — no intermediate python allocations, single pass per
// stage — for hosts where the sampler, not the TPU, is the bottleneck.
//
// Layout contract: volumes are C-order float32 (X, Y, Z) as produced by
// hdenseunet_tpu.data.nifti/preprocess; crops operate on the leading two
// axes; flip cases 0-7 match data/sampler.py::apply_flip_rot byte-for-byte
// (validated in tests/test_native.py).
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

namespace {

inline long clampl(long v, long lo, long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Catmull-Rom kernel with a = -0.75 (cv2.INTER_CUBIC's coefficient).
inline float cubic_w(float t) {
  const float A = -0.75f;
  t = std::fabs(t);
  if (t <= 1.0f) return ((A + 2.0f) * t - (A + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * A;
  return 0.0f;
}

// Map flipped-space coordinates (u, v) of an (H2, W2) view back to crop
// coordinates (i, j) in the original (H, W) crop, per augmentation case.
// Derived from numpy semantics: out = np.flipud / np.fliplr /
// np.rot90(..., axes=(1, 0)) compositions (data/sampler.py:apply_flip_rot).
inline void unmap(int cas, long u, long v, long H, long W, long* i, long* j) {
  switch (cas) {
    case 0: *i = u;          *j = v;          break;           // identity (H2=H)
    case 1: *i = H - 1 - u;  *j = v;          break;           // flipud
    case 2: *i = u;          *j = W - 1 - v;  break;           // fliplr
    case 3: *i = H - 1 - v;  *j = u;          break;           // rot90 k=1 axes(1,0): out (W,H)
    case 4: *i = v;          *j = W - 1 - u;  break;           // rot90 k=3 axes(1,0): out (W,H)
    case 5: *i = H - 1 - v;  *j = W - 1 - u;  break;           // fliplr then rot90 k=1
    case 6: *i = v;          *j = u;          break;           // fliplr then rot90 k=3
    case 7: *i = H - 1 - u;  *j = W - 1 - v;  break;           // flipud + fliplr
    default: *i = u;         *j = v;          break;
  }
}

inline bool case_swaps(int cas) { return cas >= 3 && cas <= 6; }

}  // namespace

extern "C" {

// vol: (X, Y, Z) float32 C-order; seg: same shape int16.
// Crop origin (a0, b0, c0), size (deps, rows, cols); caller guarantees
// bounds (the python side clamps). Writes out_img (out, out, cols) float32
// (mean-subtracted) and out_seg (out, out, cols) int16.
void crop_aug_resize(const float* vol, const int16_t* seg,
                     long X, long Y, long Z,
                     long a0, long b0, long c0,
                     long deps, long rows, long cols,
                     float mean, int flip_case, long out,
                     float* out_img, int16_t* out_seg) {
  (void)X;
  const long H = deps, W = rows;
  const long H2 = case_swaps(flip_case) ? W : H;
  const long W2 = case_swaps(flip_case) ? H : W;

  // 1) materialize the flipped, mean-subtracted crop contiguously (H2, W2, cols)
  //    so both resize passes stream linear memory (cache + autovectorization)
  std::vector<float> fimg(static_cast<size_t>(H2) * W2 * cols);
  std::vector<int16_t> fseg(static_cast<size_t>(H2) * W2 * cols);
  for (long u = 0; u < H2; ++u) {
    for (long v = 0; v < W2; ++v) {
      long i, j;
      unmap(flip_case, u, v, H, W, &i, &j);
      const float* src = vol + ((a0 + i) * Y + (b0 + j)) * Z + c0;
      const int16_t* ssrc = seg + ((a0 + i) * Y + (b0 + j)) * Z + c0;
      float* di = &fimg[(u * W2 + v) * cols];
      int16_t* ds = &fseg[(u * W2 + v) * cols];
      for (long k = 0; k < cols; ++k) {
        di[k] = src[k] - mean;
        ds[k] = ssrc[k];
      }
    }
  }

  const float sy = static_cast<float>(H2) / out;
  const float sx = static_cast<float>(W2) / out;

  // 2) precompute separable cubic taps (cv2-style half-pixel alignment)
  std::vector<long> ybase(out), xbase(out), ynn(out), xnn(out);
  std::vector<float> ywts(out * 4), xwts(out * 4);
  for (long o = 0; o < out; ++o) {
    const float fy = (o + 0.5f) * sy - 0.5f;
    const long y0 = static_cast<long>(std::floor(fy));
    const float ty = fy - y0;
    ybase[o] = y0;
    for (int t = 0; t < 4; ++t) ywts[o * 4 + t] = cubic_w(ty - (t - 1));
    ynn[o] = clampl(static_cast<long>(o * sy), 0, H2 - 1);  // INTER_NEAREST rule

    const float fx = (o + 0.5f) * sx - 0.5f;
    const long x0 = static_cast<long>(std::floor(fx));
    const float tx = fx - x0;
    xbase[o] = x0;
    for (int t = 0; t < 4; ++t) xwts[o * 4 + t] = cubic_w(tx - (t - 1));
    xnn[o] = clampl(static_cast<long>(o * sx), 0, W2 - 1);
  }

  // 3) vertical pass: (H2, W2, cols) -> (out, W2, cols)
  std::vector<float> vimg(static_cast<size_t>(out) * W2 * cols);
  const long rowstride = W2 * cols;
  for (long oy = 0; oy < out; ++oy) {
    const float* w4 = &ywts[oy * 4];
    const float* r0 = &fimg[clampl(ybase[oy] - 1, 0, H2 - 1) * rowstride];
    const float* r1 = &fimg[clampl(ybase[oy] + 0, 0, H2 - 1) * rowstride];
    const float* r2 = &fimg[clampl(ybase[oy] + 1, 0, H2 - 1) * rowstride];
    const float* r3 = &fimg[clampl(ybase[oy] + 2, 0, H2 - 1) * rowstride];
    float* dst = &vimg[oy * rowstride];
    for (long t = 0; t < rowstride; ++t)
      dst[t] = w4[0] * r0[t] + w4[1] * r1[t] + w4[2] * r2[t] + w4[3] * r3[t];
  }

  // 4) horizontal pass: (out, W2, cols) -> (out, out, cols); labels nearest
  for (long oy = 0; oy < out; ++oy) {
    const float* src = &vimg[oy * rowstride];
    const int16_t* srow = &fseg[ynn[oy] * rowstride];
    float* dst = &out_img[oy * out * cols];
    int16_t* dseg = &out_seg[oy * out * cols];
    for (long ox = 0; ox < out; ++ox) {
      const float* w4 = &xwts[ox * 4];
      const float* c0p = src + clampl(xbase[ox] - 1, 0, W2 - 1) * cols;
      const float* c1p = src + clampl(xbase[ox] + 0, 0, W2 - 1) * cols;
      const float* c2p = src + clampl(xbase[ox] + 1, 0, W2 - 1) * cols;
      const float* c3p = src + clampl(xbase[ox] + 2, 0, W2 - 1) * cols;
      float* d = dst + ox * cols;
      for (long k = 0; k < cols; ++k)
        d[k] = w4[0] * c0p[k] + w4[1] * c1p[k] + w4[2] * c2p[k] + w4[3] * c3p[k];
      const int16_t* s = srow + xnn[ox] * cols;
      int16_t* ds = dseg + ox * cols;
      for (long k = 0; k < cols; ++k) ds[k] = s[k];
    }
  }
}

// Plain crop + flip (no resize): used when scale == 1 and for testing the
// augmentation mapping in isolation. Outputs (H2, W2, cols).
void crop_aug(const float* vol, const int16_t* seg,
              long X, long Y, long Z,
              long a0, long b0, long c0,
              long deps, long rows, long cols,
              float mean, int flip_case,
              float* out_img, int16_t* out_seg) {
  (void)X;
  const long H = deps, W = rows;
  const long H2 = case_swaps(flip_case) ? W : H;
  const long W2 = case_swaps(flip_case) ? H : W;
  for (long u = 0; u < H2; ++u) {
    for (long v = 0; v < W2; ++v) {
      long i, j;
      unmap(flip_case, u, v, H, W, &i, &j);
      const float* src = vol + ((a0 + i) * Y + (b0 + j)) * Z + c0;
      const int16_t* ssrc = seg + ((a0 + i) * Y + (b0 + j)) * Z + c0;
      for (long k = 0; k < cols; ++k) {
        out_img[(u * W2 + v) * cols + k] = src[k] - mean;
        out_seg[(u * W2 + v) * cols + k] = ssrc[k];
      }
    }
  }
}

}  // extern "C"
