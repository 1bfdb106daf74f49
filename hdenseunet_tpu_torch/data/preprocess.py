"""Offline LiTS preparation (reference preprocessing.py, re-designed).

The port's copy of hdenseunet_tpu/data/preprocess.py, held to it by
tests/test_torch_copies.py.

The reference runs three passes over the 131 training volumes, writing
float32 ``.nii`` copies plus *text* files of every liver/tumor voxel
coordinate and a per-volume liver bounding box
(preprocessing.py:7-85; the samplers then re-parse those text lines per crop,
train_2ddense.py:58-60). Here one pass per volume produces:

* ``volumes/volume-i.npy`` — HU-clipped [-200, 250] float32 volume
  (memory-mappable, so the training sampler can run without loading all
  131 volumes into RAM the way load_fast_files does, train_2ddense.py:129-170);
* ``coords/coords-i.npz`` — liver and tumor voxel coordinates as (N, 3) int32
  arrays plus the liver bounding box, replacing LiverPixels/TumorPixels/
  LiverBox text files (no per-sample string parsing in the hot path).

Label semantics (LiTS): segmentation voxel 1 = liver, 2 = tumor.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.config import DataConfig
from . import nifti

VOLUME_DIR = "volumes"
COORD_DIR = "coords"
SEG_DIR = "segmentations"


def clip_hu(vol: np.ndarray, lo: float = -200.0, hi: float = 250.0) -> np.ndarray:
    """HU windowing (reference preprocessing.py:15-16)."""
    return np.clip(vol, lo, hi).astype(np.float32)


def extract_coords(seg: np.ndarray, *, box_labels: str = "liver") -> dict:
    """Liver/tumor voxel coordinate lists + liver bounding box.

    Replaces generate_livertxt/generate_tumortxt/generate_txt
    (preprocessing.py:21-75). ``box_labels`` selects the bounding-box support:

    * 'liver' (default, EXACT reference semantics): label==1 voxels only —
      the reference's box is min/max over the LiverPixels list, which
      generate_livertxt builds from np.where(seg==1) (preprocessing.py:21-39,
      :63-75);
    * 'any' (opt-in deviation, DataConfig.box_labels): label>=1 — a strict
      superset that additionally covers label-noise tumor voxels outside the
      label-1 support. Delta quantified in
      tests/test_data.py::test_box_mode_deviation_quantified.

    The sampled-coordinate lists themselves always follow the reference
    (liver = label==1 because tumor-guided crops draw from the tumor list).
    """
    assert box_labels in ("liver", "any"), box_labels
    liver = np.argwhere(seg == 1).astype(np.int32)
    tumor = np.argwhere(seg == 2).astype(np.int32)
    support = liver if box_labels == "liver" or not tumor.size else np.concatenate([liver, tumor])
    if support.size:
        box_min = support.min(axis=0)
        box_max = support.max(axis=0)
    else:
        box_min = np.zeros(3, np.int32)
        box_max = np.asarray(seg.shape, np.int32) - 1
    return {
        "liver": liver,
        "tumor": tumor,
        "box_min": box_min.astype(np.int32),
        "box_max": box_max.astype(np.int32),
    }


def preprocess_volume(img_path, seg_path, out_dir, index: int, cfg: DataConfig | None = None):
    """One-volume pipeline stage: clip + save npy, extract + save coords."""
    cfg = cfg or DataConfig()
    out = Path(out_dir)
    (out / VOLUME_DIR).mkdir(parents=True, exist_ok=True)
    (out / COORD_DIR).mkdir(parents=True, exist_ok=True)
    (out / SEG_DIR).mkdir(parents=True, exist_ok=True)

    vol, _ = nifti.read(img_path)
    vol = clip_hu(vol, *cfg.hu_window)
    np.save(out / VOLUME_DIR / f"volume-{index}.npy", vol)

    if seg_path is not None:
        seg, _ = nifti.read(seg_path)
        seg = np.asarray(seg, np.int16)
        np.save(out / SEG_DIR / f"segmentation-{index}.npy", seg)
        coords = extract_coords(seg, box_labels=cfg.box_labels)
        np.savez_compressed(out / COORD_DIR / f"coords-{index}.npz", **coords)
    return vol.shape


def run(raw_dir, out_dir, *, num_volumes: int | None = None, with_seg=True, cfg=None, log=print):
    """Process ``volume-i.nii[.gz]`` (+ ``segmentation-i.nii[.gz]``) files.

    Reference equivalent: the whole of preprocessing.py (main at :78-85).
    """
    cfg = cfg or DataConfig()
    raw = Path(raw_dir)
    n = num_volumes if num_volumes is not None else cfg.num_train_volumes

    def find(stem):
        for suffix in (".nii", ".nii.gz"):
            p = raw / (stem + suffix)
            if p.exists():
                return p
        raise FileNotFoundError(f"{raw}/{stem}.nii[.gz]")

    for i in range(n):
        img = find(f"volume-{i}")
        seg = find(f"segmentation-{i}") if with_seg else None
        shape = preprocess_volume(img, seg, out_dir, i, cfg)
        log(f"[{i + 1}/{n}] {img.name} -> {shape}")


class PreparedDataset:
    """Read-side view over a preprocessed directory (mmap'd volumes)."""

    def __init__(self, root, mmap: bool = True):
        self.root = Path(root)
        self.mmap = mmap
        vols = sorted(
            (self.root / VOLUME_DIR).glob("volume-*.npy"),
            key=lambda p: int(p.stem.split("-")[1]),
        )
        self.indices = [int(p.stem.split("-")[1]) for p in vols]
        if not self.indices:
            raise FileNotFoundError(f"no volumes under {self.root}/{VOLUME_DIR}")

    def __len__(self):
        return len(self.indices)

    def volume(self, i: int) -> np.ndarray:
        mode = "r" if self.mmap else None
        return np.load(self.root / VOLUME_DIR / f"volume-{i}.npy", mmap_mode=mode)

    def segmentation(self, i: int) -> np.ndarray:
        mode = "r" if self.mmap else None
        return np.load(self.root / SEG_DIR / f"segmentation-{i}.npy", mmap_mode=mode)

    def coords(self, i: int) -> dict:
        with np.load(self.root / COORD_DIR / f"coords-{i}.npz") as z:
            return {k: z[k] for k in z.files}


def synthesize(out_dir, *, num_volumes=3, shape=(96, 96, 48), seed=0, cfg=None, log=lambda *_: None):
    """Generate a tiny synthetic LiTS-like dataset (tests / smoke benchmarks).

    Volumes contain an ellipsoidal 'liver' (label 1) with an embedded 'tumor'
    sphere (label 2) on a noisy background, already HU-windowed.
    """
    rng = np.random.default_rng(seed)
    cfg = cfg or DataConfig()
    out = Path(out_dir)
    for d in (VOLUME_DIR, COORD_DIR, SEG_DIR):
        (out / d).mkdir(parents=True, exist_ok=True)
    x, y, z = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for i in range(num_volumes):
        c = np.asarray(shape) // 2 + rng.integers(-4, 5, 3)
        r = np.asarray(shape) * 0.3
        liver = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2 < 1
        tr = max(2.0, float(min(shape)) * 0.08)
        tc = c + rng.integers(-3, 4, 3)
        tumor = ((x - tc[0]) ** 2 + (y - tc[1]) ** 2 + (z - tc[2]) ** 2) < tr**2
        seg = np.zeros(shape, np.int16)
        seg[liver] = 1
        seg[tumor & liver] = 2
        vol = rng.normal(-100.0, 30.0, shape).astype(np.float32)
        vol[liver] = rng.normal(80.0, 15.0, int(liver.sum()))
        vol[seg == 2] = rng.normal(160.0, 10.0, int((seg == 2).sum()))
        vol = clip_hu(vol, *cfg.hu_window)
        np.save(out / VOLUME_DIR / f"volume-{i}.npy", vol)
        np.save(out / SEG_DIR / f"segmentation-{i}.npy", seg)
        np.savez_compressed(
            out / COORD_DIR / f"coords-{i}.npz",
            **extract_coords(seg, box_labels=cfg.box_labels),
        )
        log(f"synth volume {i}: shape={shape}")
    return out

