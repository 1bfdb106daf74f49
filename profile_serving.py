#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving path goes, on one CUDA card.

    python3 profile_serving.py [--volumes 4] [--pairs 3] [--trace PATH]

Runs the same configuration as chip_smoke.py's main path (full-preset
H-DenseUNet in bfloat16, seeded random weights, shipped InferConfig,
synthetic 512x512x96 CT volumes) and prints one line per measurement, each
with the card's name and power limit:

1. per volume, the stages of ``VolumePredictor.segment`` on the host clock:
   liver-mask extent, device scoring (``labelmask_async`` then
   ``torch.cuda.synchronize``), fetch, host CC postprocess, total;
2. the model's parts at the shapes one window run gives them (2D branch over
   36 stacks, 3D branch over 8 windows, HFF head), from CUDA events;
3. one volume's scoring under ``torch.profiler``: device time by kernel,
   total device busy time, and the device's idle share of the scoring wall
   and of the volume's end-to-end wall;
4. K1 against the plain PyTorch chain end to end, in turns (plain, K1, K1,
   plain per pair). The plain chain is switched on here only, by pointing
   ``ops.fused_affine.affine_relu`` at ``affine_relu_reference``; the package
   itself has no such switch. The K1 launch counter shows which one ran;
5. the CC postprocess on the host against on the device
   (``device_postprocess``, sparse wire), in turns (host, device, device,
   host per pair): per volume the stages extent, scoring, host postprocess
   or device compose (K4, synchronised), fetch and total; the labelmaps of
   both equal.

It raises without a card and catches nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

from chip_smoke import SEED, card_line, synthetic_case


def timed_segment(predictor, vol, ext) -> tuple[np.ndarray, dict]:
    """VolumePredictor.segment, step by step, with the device synchronised
    after scoring so each stage's host-clock time is its own."""
    from hdenseunet_tpu_torch.infer import postprocess

    t = [time.perf_counter()]
    img = np.asarray(vol, np.float32) - predictor.cfg.infer.mean
    mask, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    t.append(time.perf_counter())
    handle = predictor.windows.labelmask_async(img, z_lo, z_hi)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    packed = predictor.windows.labelmask_collect(handle)
    t.append(time.perf_counter())
    labelmap = postprocess.compose_from_masks(packed >= 1, packed >= 3, mask)
    t.append(time.perf_counter())
    names = ("extent", "scoring", "fetch", "postprocess")
    stages = {n: t[i + 1] - t[i] for i, n in enumerate(names)}
    stages["total"] = t[-1] - t[0]
    return labelmap, stages


def timed_segment_dpp(predictor, vol, ext) -> tuple[np.ndarray, dict]:
    """``VolumePredictor.segment`` with ``device_postprocess`` and the sparse
    wire, step by step: the scoring and the compose are each synchronised,
    so the compose's time on the host clock is the card's."""
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.device_pipeline import pack_labels
    from hdenseunet_tpu_torch.infer.device_postprocess import compose_final

    sc, icfg = predictor.windows, predictor.cfg.infer
    t = [time.perf_counter()]
    img = np.asarray(vol, np.float32) - icfg.mean
    mask, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    p = sc.plan(vol.shape, z_lo, z_hi)
    ext_bits = sc._ext_bits(mask, p, vol.shape)
    t.append(time.perf_counter())
    with torch.inference_mode():
        scores = pack_labels(sc._score(sc._wire(img, p), p), icfg.thres_liver, icfg.thres_tumor)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        dev = compose_final(scores, ext_bits, pack_z=p["zw"])
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    labelmap = sc._collect_sparse(dev, dict(x0=vol.shape[0], y0=vol.shape[1], z=p["z"],
                                            z_lo=p["z_lo"], z_full=vol.shape[2]))
    t.append(time.perf_counter())
    names = ("extent", "scoring", "compose", "fetch")
    stages = {n: t[i + 1] - t[i] for i, n in enumerate(names)}
    stages["total"] = t[-1] - t[0]
    return labelmap, stages


def cuda_ms(fn, iters: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def model_parts(model, cfg, card: str) -> None:
    """ms of the 2D branch, 3D branch and head at one window run's shapes,
    the 3D branch and head in the form the config serves."""
    from hdenseunet_tpu_torch.infer.device_pipeline import forms

    wb, cols, stride = cfg.infer.window_batch, cfg.infer.input_cols, cfg.infer.window_stride
    n2d = (wb - 1) * stride + cols - 2 + 2 * wb  # interior stacks + two edges per window
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, cfg.model.compute_dtype)
    stacks = (50 * torch.randn(n2d, 512, 512, 3, device="cuda", generator=gen)).to(dt)
    feat2d, logits2d = model.net2d(stacks)
    input3d = torch.randn(wb, 512, 512, cols, 4, device="cuda", generator=gen).to(dt)
    form = forms(cfg.infer)
    kw3d = dict(layout=form["layout3d"], stem_s2d=form["stem_s2d"],
                unfold_outputs=form["layout3d"] != "dhwc")
    feat3d, _ = model.net3d(input3d, **kw3d)
    fea2d = torch.randn(wb, 512, 512, cols, feat2d.shape[-1], device="cuda", generator=gen).to(dt)
    parts = {
        f"2d branch ({n2d} stacks)": lambda: model.net2d(stacks),
        f"3d branch ({wb} windows, {form})": lambda: model.net3d(input3d, **kw3d),
        "hff head": lambda: model.head(feat3d, fea2d, layout=form["layout3d"]),
    }
    for name, fn in parts.items():
        print(f"model part {name}: {cuda_ms(fn):.2f} ms per window run [{card}]")
    del feat2d, logits2d, feat3d, fea2d


def kernel_breakdown(predictor, vol, ext, card: str, trace: str | None) -> float:
    """Profile one volume's device scoring; returns device busy seconds."""
    from hdenseunet_tpu_torch.infer import postprocess

    img = np.asarray(vol, np.float32) - predictor.cfg.infer.mean
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        predictor.windows.labelmask_collect(predictor.windows.labelmask_async(img, z_lo, z_hi))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += 1
            by_kernel[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_kernel.values())
    print(
        f"profiled scoring: wall {wall:.3f} s, device busy {busy_ms:.1f} ms, "
        f"idle {100 * (1 - busy_ms / 1e3 / wall):.1f} % of the scoring wall, "
        f"{sum(n for n, _ in by_kernel.values())} device events [{card}]"
    )
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:20]
    for name, (n, ms) in top:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % x{n:<6d} {name[:110]}")
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace: {trace}")
    return busy_ms / 1e3


@contextlib.contextmanager
def plain_chain():
    """Route every bn_scale_relu through affine_relu_reference (no K1): the
    forward of ``AffineReLU`` calls the module's ``affine_relu``."""
    from hdenseunet_tpu_torch.ops import fused_affine as K

    kernel = K.affine_relu
    K.affine_relu = K.affine_relu_reference
    try:
        yield
    finally:
        K.affine_relu = kernel


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volumes", type=int, default=4, help="volumes timed stage by stage")
    ap.add_argument("--pairs", type=int, default=3, help="plain/K1/K1/plain turns")
    ap.add_argument("--trace", default=None, help="write the profiled scoring's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: torch.cuda.is_available() is false; this script needs a card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")

    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    model = init_model(HDenseUNet(preset=cfg.model.preset, device="cuda"), SEED)
    predictor = VolumePredictor(model, cfg, arch="end2end", device="cuda")
    cases = [synthetic_case(SEED + i) for i in range(max(args.volumes, 1))]

    vol, ext = cases[0]
    want = predictor.segment(vol, ext)  # also the warm-up (cuDNN's first calls)
    got, _ = timed_segment(predictor, vol, ext)
    assert np.array_equal(got, want), "the staged segment differs from VolumePredictor.segment"

    totals = []
    for i, (vol, ext) in enumerate(cases):
        _, st = timed_segment(predictor, vol, ext)
        totals.append(st["total"])
        print(
            f"volume {i} {vol.shape}: " + ", ".join(f"{k} {v:.3f} s" for k, v in st.items())
            + f" [{card}]"
        )

    model_parts(predictor.windows.model, cfg, card)
    busy = kernel_breakdown(predictor, *cases[0], card, args.trace)
    mean_total = float(np.mean(totals))
    print(
        f"device idle share of segment: {100 * (1 - busy / mean_total):.1f} % "
        f"(busy {busy:.3f} s of a mean {mean_total:.3f} s per volume) [{card}]"
    )

    vol, ext = cases[0]
    runs = {"plain": [], "k1": []}
    for _ in range(args.pairs):
        for variant in ("plain", "k1", "k1", "plain"):
            before = affine_relu.launches
            with plain_chain() if variant == "plain" else contextlib.nullcontext():
                _, st = timed_segment(predictor, vol, ext)
            launched = affine_relu.launches - before
            assert (launched == 0) == (variant == "plain"), (variant, launched)
            runs[variant].append((st["scoring"], st["total"]))
    for variant, rs in runs.items():
        print(
            f"end to end {variant}: scoring s {[round(s, 3) for s, _ in rs]}, "
            f"segment s {[round(t, 3) for _, t in rs]} [{card}]"
        )

    dpp_cfg = copy.deepcopy(cfg)
    dpp_cfg.infer = dataclasses.replace(cfg.infer, device_postprocess=True, sparse_wire=True)
    dpp = VolumePredictor(predictor.windows.model, dpp_cfg, arch="end2end", device="cuda")
    assert np.array_equal(dpp.segment(*cases[0]), want), "device postprocess differs from the host's"
    turns = {"host": [], "device": []}
    for i in range(args.pairs):
        vol, ext = cases[i % len(cases)]
        for variant in ("host", "device", "device", "host"):
            fn = timed_segment if variant == "host" else timed_segment_dpp
            lab, st = fn(predictor if variant == "host" else dpp, vol, ext)
            turns[variant].append((lab, st))
        assert np.array_equal(turns["host"][-1][0], turns["device"][-1][0])
    for variant, rs in turns.items():
        keys = rs[0][1].keys()
        print(f"postprocess on the {variant}: " + ", ".join(
            f"{k} s {[round(st[k], 4) for _, st in rs]}" for k in keys) + f" [{card}]")


if __name__ == "__main__":
    main()
