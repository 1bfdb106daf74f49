"""End-to-end volume segmentation (counterpart of
hdenseunet_tpu/infer/predictor.py; reference test.py:39-115).

The scorer runs on the device. The connected-component postprocess runs on
the host (``infer/postprocess.py`` with ``native/postprocess.cpp``) or, with
``InferConfig.device_postprocess``, on the device after the scoring
(``infer/device_postprocess.py``); both give the reference's labelmap byte
for byte.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data import nifti
from . import postprocess
from .device_pipeline import DeviceVolumeScorer


class VolumePredictor:
    """model + config -> callable volume segmenter on ``device``."""

    def __init__(self, model, cfg, *, arch: str = "end2end", device="cuda"):
        if not cfg.infer.device_resident:
            raise NotImplementedError("the host-loop window predictor is not ported yet")
        self.cfg = cfg
        self.windows = DeviceVolumeScorer(
            model,
            cfg.infer,
            arch=arch,
            compute_dtype=cfg.model.compute_dtype,
            num_classes=cfg.model.num_classes,
            device=device,
        )

    def segment(self, vol: np.ndarray, ext_liver_mask: np.ndarray) -> np.ndarray:
        """(CT volume, external liver mask) -> uint8 labelmap {0 bg,1 liver,2 tumor}."""
        return self.collect(self.dispatch(vol, ext_liver_mask))

    def dispatch(self, vol: np.ndarray, ext_liver_mask: np.ndarray):
        """Upload and queue one volume's scoring WITHOUT fetching; pair with
        :meth:`collect`. With ``device_postprocess`` the CC postprocess is
        queued too, and the handle's kind is "final"."""
        img = np.asarray(vol, np.float32) - self.cfg.infer.mean  # test.py:55
        mask, z_lo, z_hi = postprocess.liver_mask_extent(ext_liver_mask)
        if self.cfg.infer.device_postprocess:
            return "final", self.windows.labelmask_async(img, z_lo, z_hi, ext_mask=mask), None
        return "packed", self.windows.labelmask_async(img, z_lo, z_hi), mask

    def collect(self, handle) -> np.ndarray:
        """Fetch a dispatched volume's labelmask and, unless the device
        postprocessed it, postprocess it on the host."""
        kind, payload, mask = handle
        labels = self.windows.labelmask_collect(payload)
        if kind == "final":
            return labels
        return postprocess.compose_from_masks(labels >= 1, labels >= 3, mask)


def predict_directory(
    model,
    cfg,
    *,
    data_dir,
    liver_mask_dir,
    save_dir,
    num_volumes: int | None = None,
    arch: str = "end2end",
    device="cuda",
    log=print,
):
    """Segment ``test-volume-{i}.nii`` files, write labelmaps, report timing.

    Mirrors the reference CLI loop (test.py:44-115): volume ``{id}.nii`` +
    external mask ``{id}-ori.nii`` -> ``test-segmentation-{id}.nii``. The next
    volume's NIfTI read rides a loader thread, and volume i+1 is dispatched
    before volume i is collected.
    """
    data_dir = Path(data_dir)
    mask_dir = Path(liver_mask_dir)
    out_dir = Path(save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    predictor = VolumePredictor(model, cfg, arch=arch, device=device)

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
            handle = predictor.dispatch(vol, mask)
            if inflight is not None:
                finish(inflight)
            inflight = (handle, hdr, vol.shape, i)
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
