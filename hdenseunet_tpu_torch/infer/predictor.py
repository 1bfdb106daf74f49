"""End-to-end volume segmentation (counterpart of
hdenseunet_tpu/infer/predictor.py; reference test.py:39-115).

The scorer runs on the device: the device-resident scorer by default, the
host-loop ``WindowPredictor`` with ``InferConfig.device_resident=False``, or
the x/y/z-tiled scorer through :class:`TiledPredictor`. The
connected-component postprocess runs on the host (``infer/postprocess.py``
with ``native/postprocess.cpp``) or, with ``InferConfig.device_postprocess``
and the device-resident scorer, on the device after the scoring
(``infer/device_postprocess.py``); both give the reference's labelmap byte
for byte. The stages are the program's spans (``utils.profiling``): center,
mask_extent, scoring (the host's queueing of it; the scorer's upload,
window_batch and compose inside), fetch and postprocess; scoring and fetch
carry the volume's sequence number.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data import nifti
from ..utils.profiling import annotate
from . import postprocess
from .device_pipeline import DeviceVolumeScorer, TiledVolumeScorer
from .sliding_window import WindowPredictor


class VolumePredictor:
    """model + config -> callable volume segmenter on ``device``. With
    ``mesh`` every rank of it runs the same calls on the same volume, scores
    its share of the windows on its own ``device``, and returns the same
    labelmap (predictor.py:24-48)."""

    def __init__(self, model, cfg, *, arch: str = "end2end", device="cuda", mesh=None):
        self.cfg = cfg
        scorer = DeviceVolumeScorer if cfg.infer.device_resident else WindowPredictor
        self.windows = scorer(
            model,
            cfg.infer,
            arch=arch,
            compute_dtype=cfg.model.compute_dtype,
            num_classes=cfg.model.num_classes,
            device=device,
            mesh=mesh,
        )
        self.dispatched = 0  # the sequence number of the last volume dispatched

    def segment(self, vol: np.ndarray, ext_liver_mask: np.ndarray) -> np.ndarray:
        """(CT volume, external liver mask) -> uint8 labelmap {0 bg,1 liver,2 tumor}."""
        return self.collect(self.dispatch(vol, ext_liver_mask))

    def dispatch(self, vol: np.ndarray, ext_liver_mask: np.ndarray):
        """Upload and queue one volume's scoring WITHOUT fetching; pair with
        :meth:`collect`. With ``device_postprocess`` the CC postprocess is
        queued too, and the handle's kind is "final". The host loop scores
        the volume here and returns its probabilities ("probs")."""
        icfg = self.cfg.infer
        self.dispatched += 1
        seq = str(self.dispatched)
        with annotate("center"):
            img = np.asarray(vol, np.float32) - icfg.mean  # test.py:55
        with annotate("mask_extent"):
            mask, z_lo, z_hi = postprocess.liver_mask_extent(ext_liver_mask)
        with annotate("scoring", seq):
            if not icfg.device_resident:
                return "probs", self.windows.predict_volume(img, z_lo, z_hi), mask, seq
            if icfg.device_postprocess:
                return "final", self.windows.labelmask_async(img, z_lo, z_hi, ext_mask=mask), None, seq
            return "packed", self.windows.labelmask_async(img, z_lo, z_hi), mask, seq

    def collect(self, handle) -> np.ndarray:
        """Fetch a dispatched volume's labelmask and, unless the device
        postprocessed it, postprocess it on the host."""
        kind, payload, mask, seq = handle
        if kind == "probs":
            with annotate("postprocess"):
                return _compose(payload, mask, self.cfg.infer)
        with annotate("fetch", seq):
            labels = self.windows.labelmask_collect(payload)
        if kind == "final":
            return labels
        with annotate("postprocess"):
            return postprocess.compose_from_masks(labels >= 1, labels >= 3, mask)


def _compose(probs, mask, icfg) -> np.ndarray:
    """(liver_prob, tumor_prob) and the dilated external mask -> labelmap,
    thresholded and postprocessed on the host (test.py:73-115)."""
    liver_prob, tumor_prob = probs
    return postprocess.compose_labelmap(
        liver_prob, tumor_prob, mask, thres_liver=icfg.thres_liver, thres_tumor=icfg.thres_tumor,
    )


class TiledPredictor:
    """Volume segmenter over the x/y/z-tiled scorer (reference
    predict_window_mulgpu analog), for in-plane extents too large for
    full-frame windows. Same postprocess as VolumePredictor's host loop."""

    def __init__(self, model, cfg, *, tile: int, arch: str = "end2end", device="cuda"):
        self.cfg = cfg
        self.scorer = TiledVolumeScorer(
            model,
            cfg.infer,
            tile=tile,
            arch=arch,
            compute_dtype=cfg.model.compute_dtype,
            num_classes=cfg.model.num_classes,
            device=device,
        )

    def segment(self, vol: np.ndarray, ext_liver_mask: np.ndarray) -> np.ndarray:
        img = np.asarray(vol, np.float32) - self.cfg.infer.mean
        mask, _, _ = postprocess.liver_mask_extent(ext_liver_mask)
        return _compose(self.scorer.predict_volume(img), mask, self.cfg.infer)


def predict_directory(
    model,
    cfg,
    *,
    data_dir,
    liver_mask_dir,
    save_dir,
    num_volumes: int | None = None,
    arch: str = "end2end",
    tiled: int | None = None,
    device="cuda",
    log=print,
):
    """Segment ``test-volume-{i}.nii`` files, write labelmaps, report timing.

    Mirrors the reference CLI loop (test.py:44-115): volume ``{id}.nii`` +
    external mask ``{id}-ori.nii`` -> ``test-segmentation-{id}.nii``. The next
    volume's NIfTI read rides a loader thread. With the device-resident
    scorer, volume i+1 is dispatched before volume i is collected; the tiled
    scorer (``tiled``: the tile size) and the host loop segment one volume
    at a time, each timed alone.
    """
    data_dir = Path(data_dir)
    mask_dir = Path(liver_mask_dir)
    out_dir = Path(save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if tiled:
        predictor = TiledPredictor(model, cfg, tile=tiled, arch=arch, device=device)
    else:
        predictor = VolumePredictor(model, cfg, arch=arch, device=device)
    pipelined = not tiled and cfg.infer.device_resident

    n = num_volumes if num_volumes is not None else cfg.data.num_test_volumes
    times = []

    def load(i):
        vol, hdr = nifti.read(_find(data_dir, i))
        mask, _ = nifti.read(_find(mask_dir, i, suffix="-ori"))
        return vol, hdr, np.asarray(mask)

    inflight = None  # (handle, hdr, shape, index)
    last_done = time.perf_counter()

    def finish(entry):
        nonlocal last_done
        handle, hdr, shape, idx = entry
        labelmap = predictor.collect(handle)
        now = time.perf_counter()
        times.append(now - last_done)
        last_done = now
        nifti.write(out_dir / f"test-segmentation-{idx}.nii", labelmap, hdr)
        log(f"volume {idx}: {shape} segmented in {times[-1]:.2f}s")

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(load, 0) if n else None
        for i in range(n):
            vol, hdr, mask = pending.result()
            pending = pool.submit(load, i + 1) if i + 1 < n else None
            if pipelined:
                handle = predictor.dispatch(vol, mask)
                if inflight is not None:
                    finish(inflight)
                inflight = (handle, hdr, vol.shape, i)
            else:
                t0 = time.perf_counter()
                labelmap = predictor.segment(vol, mask)
                times.append(time.perf_counter() - t0)
                nifti.write(out_dir / f"test-segmentation-{i}.nii", labelmap, hdr)
                log(f"volume {i}: {vol.shape} segmented in {times[-1]:.2f}s")
        if inflight is not None:
            finish(inflight)
    if times:
        log(f"mean {np.mean(times):.2f}s/volume over {len(times)} volumes")
    return times


def _find(root: Path, index: int, suffix: str = ""):
    for stem in (f"test-volume-{index}{suffix}", f"{index}{suffix}"):
        for ext in (".nii", ".nii.gz"):
            p = root / (stem + ext)
            if p.exists():
                return p
    raise FileNotFoundError(f"{root}/[test-volume-]{index}{suffix}.nii[.gz]")
