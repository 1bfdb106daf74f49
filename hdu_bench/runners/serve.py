"""Serve runner: CT volumes through the program's ``VolumePredictor``, as
its ``predict_directory`` runs them: one client, volume i+1 dispatched
before volume i is collected.

Set-up makes the weights and a pool of volumes from the seed, hands the
weights to the program through its state dict, and serves every pool
volume once (the warm-up, whose labelmaps are checked too). The window
cycles through the pool until ``seconds`` have passed and closes when the
last volume dispatched in it has been collected: the rate is the window's
wall time over whole volumes. A traced run then profiles ``trace_volumes``
more volumes through the same loop.

``correct`` is judged in two stages, since the connected-component
postprocess turns the flip of one voxel near a threshold into the flip of a
whole component or hole (readings in PERF.md). The warm-up keeps the
thresholded labels the program's scorer hands to its postprocess (its
``compose_from_masks`` on the host, its ``compose_final`` or
``compose_packed`` on the device). Once the program is freed, the
reference (``reference/serve.py``) scores each pool volume in float32 and
again in bfloat16, the configuration's precision:

* ``raw_differ_ratio``: the share of voxels whose thresholded label the
  program gives otherwise than the float32 reference, over the share the
  bfloat16 reference gives otherwise (each plus 1e-6). With random weights
  the share swings a hundredfold from seed to seed, with how much of the
  volume the network leaves near a decision; the bfloat16 reference
  measures that for the seed at hand;
* ``postprocess_differ``: every labelmap the program returned, warm-up and
  window, against the reference's postprocess of the program's own
  thresholded labels of that volume: the voxels that differ, exactly 0.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from hdu_bench import harness, traffic
from hdu_bench.reference import models as R
from hdu_bench.reference import serve as S
from hdu_bench.weights import make_weights
from hdu_bench.work import counts


def _predictor(h, weights):
    from hdenseunet_tpu_torch.core.config import Config, InferConfig
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = h.cfg
    model = HDenseUNet(preset=cfg["port_preset"], num_classes=cfg["num_classes"], device=h.device)
    model.load_state_dict(weights)
    c = Config()
    c.model.preset = cfg["port_preset"]
    c.model.compute_dtype = cfg["precision"]
    c.model.num_classes = cfg["num_classes"]
    c.infer = InferConfig(**{**cfg["infer"], **h.traffic["program"]})
    return VolumePredictor(model, c, arch="end2end", device=h.device)


def _loop(pred, pool, spans, *, seconds=None, count=None, start=0):
    """Serve pool volumes in order from ``start``, one in flight ahead, for
    ``seconds`` or ``count`` dispatches; returns ([(pool index, labelmap)],
    wall seconds from the first dispatch to the last collect's end)."""
    served, inflight, k = [], None, 0
    t0 = time.perf_counter()
    while (k < count) if count is not None else (time.perf_counter() - t0 < seconds or k == 0):
        i = (start + k) % len(pool)
        with spans.span("dispatch"):
            handle = pred.dispatch(*pool[i])
        if inflight is not None:
            with spans.span("collect"):
                served.append((inflight[0], pred.collect(inflight[1])))
        inflight, k = (i, handle), k + 1
    with spans.span("collect"):
        served.append((inflight[0], pred.collect(inflight[1])))
    harness.synchronize(pred.windows.device)
    return served, time.perf_counter() - t0


class _RawLabels:
    """Keeps the thresholded labels that the program's scorer hands to its
    postprocess, as a full volume coded 0 / 1 / 3, while open; the
    program's functions are put back on close. The program has no entry
    that returns them, so this wraps three of its internal functions by
    name (PERF.md lists the entry a later change to the program should
    give)."""

    def __init__(self, shape, infer, ext_mask):
        from hdenseunet_tpu_torch.infer import device_pipeline, postprocess

        self.got = []
        x, y, z = shape
        _, lo, hi = S.liver_extent(ext_mask)
        starts = S.window_starts(z, lo, hi, infer)
        z_lo, z_hi = min(starts), min(z, max(starts) + infer["input_cols"])
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (postprocess, "compose_from_masks"), (device_pipeline, "compose_final"),
            (device_pipeline, "compose_packed"))]
        host, final, packed = (fn for _, _, fn in self.saved)

        def on_host(liver, tumour, ext):
            self.got.append((liver | tumour).astype(np.uint8) + 2 * tumour.astype(np.uint8))
            return host(liver, tumour, ext)

        def on_device(fn):
            def wrapped(labels, ext_bits, *, pack_z):
                full = np.zeros(shape, np.uint8)
                full[:, :, z_lo:z_hi] = labels[:x, :y, : z_hi - z_lo].cpu().numpy()
                self.got.append(full)
                return fn(labels, ext_bits, pack_z=pack_z)
            return wrapped

        postprocess.compose_from_masks = on_host
        device_pipeline.compose_final = on_device(final)
        device_pipeline.compose_packed = on_device(packed)

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _control(h, weights, pool):
    """The reference in the program's place, in the control's precision:
    (its labelmaps, its thresholded labels)."""
    served, raw = [], {}
    for i, (vol, mask) in enumerate(pool):
        scores, ext = S.probabilities(R.Fp8Ops(), vol, mask, weights, h.cfg, h.device)
        raw[i] = S.raw_labels(scores, h.cfg["infer"])
        served.append((i, S.postprocess_raw(raw[i], ext)))
    return served, raw


def _near(scores, infer, band=0.01) -> list:
    """Shares of voxels whose liver and tumour scores lie within ``band`` of
    their thresholds."""
    nc = scores.shape[-1]
    return [float(np.mean(np.abs(scores[..., nc - 2] - infer["thres_liver"]) < band)),
            float(np.mean(np.abs(scores[..., nc - 1] - infer["thres_tumor"]) < band))]


def run(h) -> dict:
    out = {"metrics": {}, "units": {"setup_s": "s", h.traffic["metric"]: "s/volume"}}
    pool = traffic.serve_pool(h.traffic, h.seed, h.device)
    weights = make_weights(h.cfg, h.seed, h.device)
    served, raw = [], {}
    if h.control:
        with h.reference_precision():
            served, raw = _control(h, weights, pool)
        out["device"] = harness.device_record(h.device, h.chips)
    else:
        pred = _predictor(h, weights)
        h.apply_faults(pred=pred)
        for i, (vol, mask) in enumerate(pool):  # the warm-up: every pool volume once
            keep = _RawLabels(vol.shape, h.cfg["infer"], mask)
            try:
                served.append((i, pred.segment(vol, mask)))
            finally:
                keep.close()
            raw[i] = keep.got[0]
        harness.synchronize(h.device)
        out["metrics"]["setup_s"] = time.perf_counter() - h.t_start
        window, seconds = _loop(pred, pool, h.spans, seconds=h.seconds)
        served += window
        out["spans"] = dict(h.spans.totals)
        out["metrics"][h.traffic["metric"]] = seconds / len(window)
        out["count"] = len(window)
        out["device"] = harness.device_record(h.device, h.chips)
        if h.trace:
            with harness.profiled(h.spans, h.device, h.scratch) as summary:
                traced, _ = _loop(pred, pool, h.spans, count=h.traffic["trace_volumes"],
                                  start=len(window))
            served += traced
            out["trace"], out["traced_units"] = summary, len(traced)
        del pred
        gc.collect()
        if torch.device(h.device).type == "cuda":
            torch.cuda.empty_cache()
    out["attempted"] = len(served)
    out["failed"] = sum(1 for _, lab in served if lab.shape != pool[0][0].shape)

    infer = h.cfg["infer"]
    with h.reference_precision():
        for i, (vol, mask) in enumerate(pool):
            scores, ext = S.probabilities(R.Float32Ops(), vol, mask, weights, h.cfg, h.device)
            ref_raw = S.raw_labels(scores, infer)
            half_raw = S.raw_labels(S.probabilities(R.Bf16Ops(), vol, mask, weights, h.cfg,
                                                    h.device)[0], infer)
            share = float(np.count_nonzero(raw[i] != ref_raw)) / ref_raw.size
            half = float(np.count_nonzero(half_raw != ref_raw)) / ref_raw.size
            h.checks.put("raw_differ_ratio", (share + 1e-6) / (half + 1e-6))
            print(f"volume {i}: thresholded labels {np.bincount(ref_raw.ravel(), minlength=4).tolist()}"
                  f" in the reference; given otherwise on a share {share:.4g} (bfloat16 reference"
                  f" {half:.4g}), widest margin {S.disagreement(raw[i], ref_raw, scores, infer):.4g};"
                  f" within 0.01 of a threshold {_near(scores, infer)}", file=sys.stderr)
            expect = S.postprocess_raw(raw[i], ext)
            for j, lab in served:
                if j == i:
                    same_shape = lab.shape == expect.shape
                    differ = int(np.count_nonzero(lab != expect)) if same_shape else lab.size
                    h.checks.put("postprocess_differ", float(differ))

    _, lo, hi = S.liver_extent(pool[0][1])
    pk = counts.peaks(out["device"]["kind"])
    out["work"] = {**counts.serve_volume(h.cfg, pool[0][0].shape, (lo, hi), pk), "peaks": pk}
    return out
