"""Liver/tumor-guided crop sampler + augmentation (host-side, numpy).

Counterpart of hdenseunet_tpu/data/sampler.py, which re-implements the
reference's training sampler recipe (train_2ddense.py:40-126 /
train_hybrid.py:40-133) with an explicit ``np.random.Generator``:

* random isotropic in-plane scale U(0.8, 1.2) of the crop window (:48-50);
* a random liver- or tumor-voxel *center*, clamped so the crop stays inside
  the liver bounding box dilated by 3 voxels (:53-63; box dilation
  train_2ddense.py:151-156);
* 50/50 liver- vs tumor-guided choice, with liver-guided forced for the 13
  tumor-free volumes (:39, :111-117);
* mean subtraction (:65), one of 8 flip/rot90 augmentations (:67-94);
* resize back to (input_size, input_size, z), a per-slice 2D resize: cubic
  for the image, nearest for the mask (:96-97).

The same seed gives the JAX package's batches byte for byte. The resize
families are ``DataConfig.resize_backend``'s:

* 'cv2' (the default) — cv2's INTER_CUBIC (Catmull-Rom) / INTER_NEAREST
  arithmetic, run by the native core (``native/sampler.cpp``, a copy of the
  JAX package's) fused with the crop, mean subtraction and augmentation.
  The port does not import cv2. Without the native core it raises: the JAX
  package would fall back to scipy's B-spline family there, which changes
  the training data without a word;
* 'spline' — ``scipy.ndimage.zoom(grid_mode=True)``, the skimage.resize
  family the reference uses.

2D stage: crops are (H, W, 3) slabs, label = center slice. Hybrid stage:
crops are (H, W, D=input_cols) sub-volumes with full masks; batches missing
any of the 3 classes are re-drawn (train_hybrid.py:127-132), a bounded
number of times.

``batches(batch, threads=N)`` crops samples on a persistent thread pool with
a counter-based RNG (each sample's stream is a function of (seed, index,
attempt)), so the batches are the same bits for any thread count >= 1;
``threads=None`` keeps the sequential stream. The native call releases the
GIL. Each volume is memory-mapped once per sampler, not once per sample as
in the JAX package: that doubles the crop rate (profile_feed.py, PERF.md).
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy import ndimage

from .. import native
from ..core.config import DataConfig
from .preprocess import PreparedDataset

_FLIP_CASES = 8
_MAX_BATCH_RETRIES = 16
_NATIVE_MAX_Z = 128  # the JAX package resizes deeper stacks with scipy (cv2's limit)


def _require_native():
    if not native.available():
        raise RuntimeError(
            "resize_backend 'cv2' runs through the native sampler core "
            "(native/sampler.cpp), which did not build: install g++ or set "
            "data.resize_backend to 'spline' (a different cubic family)"
        )


def resize_2d_stack(
    vol: np.ndarray,
    out_hw: tuple[int, int],
    *,
    nearest: bool,
    backend: str = "cv2",
) -> np.ndarray:
    """Resize (H, W, Z) -> (out_h, out_w, Z), z untouched.

    Cubic (image) / nearest (mask), like reference train_2ddense.py:96-97.
    'cv2' runs the native core's cv2 arithmetic (square outputs only) for
    stacks of at most 128 slices; 'spline', and deeper stacks, run
    ``ndimage.zoom`` with grid_mode=True: order 3 mode 'grid-constant' for
    images, order 0 mode 'nearest' (== skimage 'edge') for masks.
    """
    h, w = out_hw
    if vol.shape[:2] == (h, w):
        return vol
    if backend == "cv2" and vol.shape[2] <= _NATIVE_MAX_Z:
        _require_native()
        if h != w:
            raise ValueError(f"the native resize makes square slices, not {out_hw}")
        img = np.zeros(vol.shape, np.float32) if nearest else vol
        seg = vol if nearest else np.zeros(vol.shape, np.int16)
        out_img, out_seg = native.crop_aug_resize(
            img, seg, (0, 0, 0), vol.shape, mean=0.0, flip_case=0, out_size=h
        )
        return out_seg.astype(vol.dtype, copy=False) if nearest else out_img
    zoom = (h / vol.shape[0], w / vol.shape[1], 1.0)
    order = 0 if nearest else 3
    return ndimage.zoom(
        vol, zoom, order=order, mode="nearest" if nearest else "grid-constant",
        grid_mode=True,
    )


def apply_flip_rot(img: np.ndarray, mask: np.ndarray, case: int):
    """One of the reference's 8 augmentation cases (train_2ddense.py:67-94).

    Cases operate on the leading two (in-plane) axes; z rides along.
    """
    if case == 1:
        img, mask = np.flipud(img), np.flipud(mask)
    elif case == 2:
        img, mask = np.fliplr(img), np.fliplr(mask)
    elif case == 3:
        img = np.rot90(img, 1, (1, 0))
        mask = np.rot90(mask, 1, (1, 0))
    elif case == 4:
        img = np.rot90(img, 3, (1, 0))
        mask = np.rot90(mask, 3, (1, 0))
    elif case == 5:
        img = np.rot90(np.fliplr(img), 1, (1, 0))
        mask = np.rot90(np.fliplr(mask), 1, (1, 0))
    elif case == 6:
        img = np.rot90(np.fliplr(img), 3, (1, 0))
        mask = np.rot90(np.fliplr(mask), 3, (1, 0))
    elif case == 7:
        img = np.fliplr(np.flipud(img))
        mask = np.fliplr(np.flipud(mask))
    return img, mask


class CropSampler:
    """Stateful sampler over a :class:`PreparedDataset`.

    ``mode='2d'`` yields ((H,W,3) slab, (H,W) center-slice label);
    ``mode='hybrid'`` yields ((H,W,D) sub-volume, (H,W,D) label volume).
    ``use_native`` may be left None; False with the 'cv2' backend raises,
    since only the native core computes that family here.
    """

    def __init__(
        self,
        dataset: PreparedDataset,
        cfg: DataConfig | None = None,
        *,
        mode: str = "2d",
        input_size: int = 224,
        input_cols: int = 8,
        seed: int = 0,
        use_native: bool | None = None,
    ):
        if mode not in ("2d", "hybrid"):
            raise ValueError(f"mode must be '2d' or 'hybrid', not {mode!r}")
        self.ds = dataset
        self.cfg = cfg or DataConfig()
        self.mode = mode
        self.input_size = int(input_size)
        self.cols = 3 if mode == "2d" else int(input_cols)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self._cache: dict[int, tuple] = {}
        self._maps: dict[int, tuple] = {}
        backend = self.cfg.resize_backend
        if backend not in ("cv2", "spline"):
            raise ValueError(f"resize_backend must be 'cv2' or 'spline', not {backend!r}")
        self.use_native = backend == "cv2"
        if self.use_native:
            if use_native is False:
                raise ValueError("resize_backend 'cv2' needs the native core: use_native=False")
            _require_native()

    # -- per-volume cached arrays and metadata ------------------------------
    def _arrays(self, i: int):
        """(volume, segmentation) of volume i, memory-mapped once."""
        if i not in self._maps:
            self._maps[i] = (self.ds.volume(i), self.ds.segmentation(i))
        return self._maps[i]

    def _meta(self, i: int):
        if i not in self._cache:
            c = self.ds.coords(i)
            shape = np.asarray(self._arrays(i)[0].shape, np.int64)
            d = self.cfg.box_dilation
            mn = np.maximum(c["box_min"] - d, 0)
            mx = np.minimum(shape, c["box_max"] + d)  # exclusive-ish, per reference
            self._cache[i] = (c["liver"], c["tumor"], mn, mx)
        return self._cache[i]

    def _pick_center(self, i: int, rng: np.random.Generator) -> np.ndarray:
        liver, tumor, _, _ = self._meta(i)
        tumor_free = i in self.cfg.tumor_free_volumes
        use_liver = (
            tumor_free
            or len(tumor) == 0
            or rng.random() < self.cfg.liver_sample_prob
        )
        coords = liver if use_liver else tumor
        if len(coords) == 0:
            # degenerate volume: fall back to its geometric center
            shape = np.asarray(self._arrays(i)[0].shape)
            return shape // 2
        return coords[rng.integers(0, len(coords))]

    def sample_one(
        self,
        volume_index: int | None = None,
        rng: np.random.Generator | None = None,
    ):
        """One (image, label) crop, augmented and resized.

        ``rng`` defaults to the sampler's sequential stream; parallel callers
        pass a per-sample counter-derived generator (see :meth:`sample_at`).
        """
        rng = self.rng if rng is None else rng
        i = (
            int(rng.integers(0, len(self.ds)))
            if volume_index is None
            else volume_index
        )
        i = self.ds.indices[i % len(self.ds.indices)]
        img, seg = self._arrays(i)
        _, _, mn, mx = self._meta(i)
        shape = np.asarray(img.shape, np.int64)

        scale = rng.uniform(*self.cfg.scale_range)
        # the window never exceeds the volume; the resize restores input_size
        deps = min(int(self.input_size * scale), int(shape[0]))
        rows = min(int(self.input_size * scale), int(shape[1]))
        cols = self.cols
        if shape[2] < cols:
            raise ValueError(f"volume {i} z-extent {shape[2]} < window depth {cols}")
        cen = self._pick_center(i, rng)

        # clamp the center so the window sits inside the dilated box where it
        # fits, inside the volume always (train_2ddense.py:53-63)
        half = np.array([deps // 2, rows // 2, cols // 2])
        size = np.array([deps, rows, cols])
        lo = np.clip(np.minimum(np.maximum(mn + half, cen), mx - half - 1), half, shape - (size - half))
        a, b, c = (int(v) for v in lo)

        origin = (a - deps // 2, b - rows // 2, c - cols // 2)
        case = int(rng.integers(0, _FLIP_CASES))

        sl = tuple(slice(o, o + s) for o, s in zip(origin, (deps, rows, cols)))
        if self.use_native:
            # one fused C call; the crop itself stays numpy, so mmap'd
            # volumes only materialize the cropped region
            crop_img, crop_seg = native.crop_aug_resize(
                np.ascontiguousarray(img[sl], np.float32),
                np.ascontiguousarray(seg[sl], np.int16),
                (0, 0, 0),
                (deps, rows, cols),
                mean=self.cfg.mean,
                flip_case=case,
                out_size=self.input_size,
            )
        else:
            crop_img = np.asarray(img[sl], np.float32) - self.cfg.mean
            crop_seg = np.asarray(seg[sl])
            crop_img, crop_seg = apply_flip_rot(crop_img, crop_seg, case)
            out_hw = (self.input_size, self.input_size)
            crop_img = resize_2d_stack(crop_img, out_hw, nearest=False, backend="spline")
            crop_seg = resize_2d_stack(
                crop_seg.astype(np.int16), out_hw, nearest=True, backend="spline"
            )

        if self.mode == "2d":
            return crop_img, crop_seg[:, :, 1]
        return crop_img, crop_seg

    def sample_at(self, index: int, attempt: int = 0):
        """Sample #index with a counter-derived RNG: a pure function of
        (seed, index, attempt), whichever thread computes it."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, int(index), int(attempt)))
        )
        return self.sample_one(rng=rng)

    def _assemble(self, pairs, *, force: bool = False):
        """Stack (img, label) pairs into a batch dict.

        Returns None for a hybrid batch missing one of the 3 classes
        (reference train_hybrid.py:127-132) unless ``force``.
        """
        image = np.stack([p[0] for p in pairs]).astype(np.float32)
        label = np.stack([p[1] for p in pairs]).astype(np.int32)
        if self.mode == "hybrid":
            image = image[..., None]
            if not force and not all((label == c).any() for c in range(3)):
                return None
        return {"image": image, "label": label}

    def sample_batch(self, batch: int):
        """Assemble a batch as a dict of stacked arrays.

        2d:     image (B,H,W,3)        label (B,H,W)
        hybrid: image (B,H,W,D,1)      label (B,H,W,D)  — re-drawn until all
        three classes are present, at most 16 times.
        """
        for _attempt in range(_MAX_BATCH_RETRIES):
            pairs = [self.sample_one() for _ in range(batch)]
            out = self._assemble(pairs)
            if out is not None:
                return out
        return self._assemble(pairs, force=True)

    def batches(self, batch: int, threads: int | None = None):
        """Infinite batch generator (reference generate_arrays_from_file).

        ``threads >= 1`` crops samples on a persistent pool with the
        counter-based RNG: the same bits for every thread count, 1
        included. ``threads=None`` keeps the sequential ``self.rng``
        stream (a different stream by construction).
        """
        if threads is not None and threads >= 1:
            yield from self._parallel_batches(batch, max(1, threads))
            return
        while True:
            yield self.sample_batch(batch)

    def _parallel_batches(self, batch: int, threads: int, lookahead: int = 2):
        """Deterministic multi-threaded batch producer.

        Keeps ``lookahead`` future batches' samples in flight so the pool
        stays busy across batch boundaries; hybrid class-rejection re-draws
        the same index range at attempt+1 (still deterministic).
        """
        ex = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="crop")

        def submit(start, attempt):
            return [ex.submit(self.sample_at, start + j, attempt) for j in range(batch)]

        pending: deque = deque()
        next_start = 0
        try:
            for _ in range(lookahead + 1):
                pending.append((next_start, 0, submit(next_start, 0)))
                next_start += batch
            while True:
                start, attempt, futs = pending.popleft()
                pairs = [f.result() for f in futs]
                out = self._assemble(pairs)
                if out is None and attempt + 1 < _MAX_BATCH_RETRIES:
                    pending.appendleft((start, attempt + 1, submit(start, attempt + 1)))
                    continue
                if out is None:
                    out = self._assemble(pairs, force=True)
                pending.append((next_start, 0, submit(next_start, 0)))
                next_start += batch
                yield out
        finally:
            ex.shutdown(wait=False, cancel_futures=True)


def synthetic_batches(
    *, mode="2d", batch=2, input_size=224, input_cols=8, seed=0, classes=3
):
    """Random batches with the training pipeline's exact shapes/dtypes, in
    the JAX package's numpy draws (sampler.py:355-370).

    For benchmarks and tests that need the device path without LiTS on disk.
    """
    rng = np.random.default_rng(seed)
    while True:
        if mode == "2d":
            image = rng.normal(0, 60, (batch, input_size, input_size, 3)).astype(np.float32)
            label = rng.integers(0, classes, (batch, input_size, input_size), dtype=np.int32)
        else:
            image = rng.normal(0, 60, (batch, input_size, input_size, input_cols, 1)).astype(np.float32)
            label = rng.integers(0, classes, (batch, input_size, input_size, input_cols), dtype=np.int32)
        yield {"image": image, "label": label}
