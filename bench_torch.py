#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card, under bench.py's
definitions, protocol and key names.

    python3 bench_torch.py                      # on the card, at the defaults
    BENCH_CPU=1 BENCH_PRESET=tiny BENCH_Z=32 ... python3 bench_torch.py   # CPU smoke

It mirrors ``bench.py`` (the JAX package's harness) function by function,
with the same environment knobs and defaults, and prints a JSON line with
the same keys, so the card's line sits beside the TPU's ``BENCH_r0*.json``:

* ``value`` (s/volume, ``vs_baseline``, ``model_tflops``,
  ``achieved_tflops``, ``mfu``): the minimum over BENCH_REPS of
  ``DeviceVolumeScorer.summarize`` on a 512xZ volume, end to end (the
  volume's h2d, the scoring, the digest's fetch);
* ``compute_s_per_volume`` (or ``compute_unreliable``), ``compute_mfu``,
  ``compute_spread``, ``compute_t_small_s``, ``compute_t_big_s``,
  ``compute_k_big``: the slope between k = 1 and k = BENCH_COMPUTE_K
  scorings back to back on one wire already on the card
  (``compute_timer``), under bench.py's hardened protocol
  (:func:`hardened_slope`: interleaved endpoints, minima, one merged retry,
  ``*_unreliable`` instead of a non-monotone number). The scorer's own
  ``compute_seconds`` (sorted, unpaired minima) is not used here;
* ``dispatch_s``, ``h2d_s``, ``wire_mb``, ``decomp_gap_s``: one tiny device
  op and its ``.item()``; the copy of a host bfloat16 buffer of the wire's
  shape to the card as the scorer's ``_wire`` moves it (pageable), then a
  fetch; ``value - (compute + h2d + dispatch)``;
* ``pipelined_s_per_volume``, ``pipelined_volumes``,
  ``pipelined_vs_baseline``: BENCH_PIPELINE_VOLUMES volumes through
  ``VolumePredictor.dispatch``/``collect``, one in flight ahead, with the
  host CC postprocess (skipped under BENCH_SHARED2D=1, as in bench.py);
* ``train_ms_per_step``, ``train_slices_per_s_chip``, ``train_mfu``,
  ``train_compute_spread``, then ``train_compute_ms_per_step``,
  ``train_compute_slices_per_s_chip`` and ``train_compute_mfu`` or
  ``train_compute_unreliable`` with ``train_compute_t_small_s`` and
  ``train_compute_t_big_s``: the 2D stage (batch 8 of 224x224, bfloat16,
  remat), the minimum over BENCH_TRAIN_REPS of BENCH_TRAIN_STEPS chained
  steps; MFU counts 3 x the forward's conv FLOPs (train-mode BN, no
  dropout) over the bf16 peak;
* ``card`` and ``power_limit_w``: ``nvidia-smi``'s name and power limit
  (``"cpu"`` and null under BENCH_CPU=1), so every number carries its card.

Where the definitions differ from bench.py's:

1. Weights: the end2end hybrid and the 2D stage come from the port's seeded
   initializer (seed 0 and ``train.seed``). JAX's ``jax.random.key(0)``
   draws cannot be made where the card is (no JAX there), and no trained
   checkpoint is in the repository. The digest's values differ; the work
   does not.
2. ``estimate_flops`` counts the window batches the port runs. The JAX
   count adds the plan's all-zero padding batches, which its compiled
   program runs and the port skips, so the port's ``model_tflops`` and the
   MFU keys over it are lower by exactly those batches.
3. The train slope's endpoints are ``trainer.make_multi_step`` at k =
   BENCH_TRAIN_K_SMALL and BENCH_TRAIN_K_BIG (JAX: ``lax.scan`` over k
   steps): one captured CUDA graph of a step, replayed k times a call. Each
   call takes k copies of the batch that is already on the card, as
   bench.py's ``stacked`` was put there once outside the timed window; only
   the k seeds are copied in it. The state advances in place, where JAX
   restarted every call from the same state. Each endpoint is warmed with
   two calls: the first runs its steps eagerly, the second captures the
   graph.

The line is printed after every phase, cumulative, headline first: the
last line is the whole one. A phase that fails (compute slope, pipelined
loop, train) puts ``*_error: true`` into the line, as bench.py's fences do,
and the script then exits 1 after its last line. It runs on the card
unless BENCH_CPU=1 asks for the CPU, and raises without one. Under
BENCH_CPU=1 the MFU keys are against a nominal 1 TFLOP/s: a CPU run's MFU
measures nothing. BENCH_UNROLL (bench.py's
``batch_unroll``, a ``lax.scan`` unroll) has no counterpart in the port,
whose window loop is a Python loop: set, it stops the script.

Env knobs, defaults as bench.py's: BENCH_PRESET=full, BENCH_Z=192,
BENCH_REPS=5, BENCH_WINDOW_BATCH=8, BENCH_SHARED2D=0, BENCH_COMPUTE=1,
BENCH_COMPUTE_K=5, BENCH_COMPUTE_REPS=8, BENCH_PIPELINE=1,
BENCH_PIPELINE_VOLUMES=3, BENCH_TRAIN=1, BENCH_TRAIN_BATCH=8,
BENCH_TRAIN_STEPS=20, BENCH_TRAIN_REPS=3, BENCH_TRAIN_SLOPE_REPS=8,
BENCH_TRAIN_K_SMALL=4, BENCH_TRAIN_K_BIG=64, BENCH_CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

BASELINE_SEC_PER_VOLUME = 100.0


def _note(msg: str) -> None:
    """Progress marker on stderr (stdout carries only the JSON lines)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def hardened_slope(timed_small, timed_big, k_small: int, k_big: int, reps: int):
    """Interleaved min-over-reps slope with monotonicity guards.

    ``timed_small``/``timed_big`` run the two endpoint programs (already
    compiled + warm) and return wall seconds. Endpoints are round-robined so
    both sample the same relay weather; the slope is computed from the
    endpoint minima. If the minima are non-monotone (slope <= 0), one full
    retry rep-set is merged in; if still violated, ``unreliable`` is True and
    the caller must not publish the number (VERDICT r4 item 1).
    """
    t_small: list[float] = []
    t_big: list[float] = []

    def rounds(n):
        for _ in range(n):
            t_small.append(timed_small())
            t_big.append(timed_big())

    rounds(reps)
    if min(t_big) <= min(t_small):
        rounds(reps)  # one retry: merged minima
    slope = (min(t_big) - min(t_small)) / (k_big - k_small)

    def spread(ts):
        return (max(ts) - min(ts)) / max(min(ts), 1e-9)

    return {
        "slope": slope,
        "unreliable": slope <= 0.0,
        "spread": max(spread(t_small), spread(t_big)),
        "t_small_min": min(t_small),
        "t_big_min": min(t_big),
    }


def bench_device() -> torch.device:
    """The card, or the CPU when BENCH_CPU=1 asks for it; no card and no
    BENCH_CPU stops the script."""
    if os.environ.get("BENCH_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            "bench_torch: torch.cuda.is_available() is false; this script needs a card "
            "(BENCH_CPU=1 runs its CPU smoke)"
        )
    return torch.device("cuda")


def card_keys(device: torch.device) -> dict:
    """``card`` and ``power_limit_w`` from nvidia-smi (watts as a number
    where it gives one), or the CPU's."""
    if device.type != "cuda":
        return {"card": "cpu", "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    watts = re.fullmatch(r"([0-9.]+) W", limit)
    return {"card": name, "power_limit_w": float(watts.group(1)) if watts else limit}


def peak_flops(device: torch.device) -> float:
    """The card's bf16 peak (``utils.flops.peak_flops_per_chip``); on the
    CPU, a nominal 1 TFLOP/s."""
    if device.type != "cuda":
        return 1e12
    from hdenseunet_tpu_torch.utils.flops import peak_flops_per_chip

    return peak_flops_per_chip()


def volume_case(size: int, z: int):
    """bench.py's synthetic volume and liver z-range: (vol, mini_z, maxi_z)."""
    rng = np.random.default_rng(0)
    vol = rng.normal(0.0, 60.0, (size, size, z)).astype(np.float32)
    return vol, int(z * 0.2), int(z * 0.8)


def pipeline_mask(shape, mini_z: int, maxi_z: int) -> np.ndarray:
    """bench.py's external liver mask for the pipelined loop."""
    mask = np.zeros(shape, np.uint8)
    mask[64:-64, 64:-64, mini_z:maxi_z] = 1
    return mask


def measure_train(preset: str, device: torch.device) -> dict:
    """Chained 2D-stage train step: ms/step, slices/s/chip, train MFU."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.models import denseunet2d
    from hdenseunet_tpu_torch.parallel.multihost import put_batch
    from hdenseunet_tpu_torch.train import trainer
    from hdenseunet_tpu_torch.utils.flops import conv_flops

    batch = int(os.environ.get("BENCH_TRAIN_BATCH", "8"))
    size = 224 if preset == "full" else 64
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "20"))
    reps = int(os.environ.get("BENCH_TRAIN_REPS", "3"))
    slope_reps = int(os.environ.get("BENCH_TRAIN_SLOPE_REPS", "8"))

    cfg = Config()
    cfg.model.preset = preset
    cfg.model.input_size = size
    cfg.model.compute_dtype = "bfloat16"
    cfg.train.arch = "2d"
    cfg.train.batch = batch
    cfg.train.remat = True

    state = trainer.create_train_state(cfg, "2d", device=device)
    host = next(synthetic_batches(mode="2d", batch=batch, input_size=size))
    db = put_batch(host, device)

    _note("train: first step")
    loss = trainer.train_step(state, db, cfg)
    assert np.isfinite(float(loss))

    def loop():
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = trainer.train_step(state, db, cfg)
        final = float(loss)  # scalar d2h = sync
        assert np.isfinite(final)
        return (time.perf_counter() - t0) / steps

    _note("train: chained loops")
    dt = min(loop() for _ in range(reps))

    # The relay-immune twin: K steps a call, one captured CUDA graph of the
    # step replayed K times (module docstring, difference 3); the slope
    # between the K_SMALL and K_BIG calls cancels the per-call cost.
    k_small, k_big = (
        int(os.environ.get("BENCH_TRAIN_K_SMALL", "4")),
        int(os.environ.get("BENCH_TRAIN_K_BIG", "64")),
    )

    def make_timed(k):
        multi = trainer.make_multi_step(state, cfg, k=k)
        stacked = [db] * k  # on the card already: no host copy in the window

        def timed():
            t0 = time.perf_counter()
            losses = multi(stacked)
            final = float(losses[-1])  # scalar d2h = sync
            assert np.isfinite(final)
            return time.perf_counter() - t0

        timed()  # eager: the warm-up
        timed()  # captures the step, then replays it
        return timed

    _note(f"train: capturing graphed endpoints k={k_small},{k_big}")
    timed_small, timed_big = make_timed(k_small), make_timed(k_big)
    _note("train: interleaved slope reps")
    sl = hardened_slope(timed_small, timed_big, k_small, k_big, slope_reps)

    net = denseunet2d.DenseUNet2D(
        num_classes=cfg.model.num_classes, device="meta", **denseunet2d.PRESETS[preset]
    )
    fwd = conv_flops(net, (batch, size, size, 3), bn_frozen=False, decoder_dropout=0.0)
    peak = peak_flops(device)
    out = {
        "train_ms_per_step": round(dt * 1e3, 2),
        "train_slices_per_s_chip": round(batch / dt, 1),
        "train_mfu": round(3.0 * fwd / dt / peak, 4),
        "train_compute_spread": round(sl["spread"], 3),
    }
    if sl["unreliable"]:
        out["train_compute_unreliable"] = True
        out["train_compute_t_small_s"] = round(sl["t_small_min"], 3)
        out["train_compute_t_big_s"] = round(sl["t_big_min"], 3)
    else:
        dt_c = sl["slope"]
        out.update(
            {
                "train_compute_ms_per_step": round(dt_c * 1e3, 2),
                "train_compute_slices_per_s_chip": round(batch / dt_c, 1),
                "train_compute_mfu": round(3.0 * fwd / dt_c / peak, 4),
            }
        )
    return out


def measure_pipelined(model, icfg, preset: str, vol, mini_z, maxi_z, device) -> dict:
    """Amortized s/volume through the production pipelined serving loop."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor

    nvol = int(os.environ.get("BENCH_PIPELINE_VOLUMES", "3"))
    cfg = Config()
    cfg.model.preset = preset
    cfg.model.input_size = icfg.input_size
    cfg.model.compute_dtype = "bfloat16"
    cfg.infer = icfg
    pred = VolumePredictor(model, cfg, arch="end2end", device=device)
    mask = pipeline_mask(vol.shape, mini_z, maxi_z)

    # warm: one full dispatch+collect (incl. host postprocess)
    lm = pred.segment(vol, mask)
    assert lm.shape == vol.shape and lm.dtype == np.uint8

    t0 = time.perf_counter()
    inflight = None
    for _ in range(nvol):
        handle = pred.dispatch(vol, mask)
        if inflight is not None:
            pred.collect(inflight)
        inflight = handle
    pred.collect(inflight)
    dt = (time.perf_counter() - t0) / nvol
    return {
        "pipelined_s_per_volume": round(dt, 3),
        "pipelined_volumes": nvol,
        "pipelined_vs_baseline": round(BASELINE_SEC_PER_VOLUME / max(dt, 1e-9), 2),
    }


def fenced(line: dict, name: str, phase) -> None:
    """Run one phase into ``line``; a failure becomes ``{name}_error``."""
    try:
        line.update(phase())
    except Exception as e:  # the phase's boundary: report it, go on, exit 1 at the end
        _note(f"{name} phase failed: {type(e).__name__}: {e}")
        traceback.print_exc()
        line[f"{name}_error"] = True


def main() -> int:
    """Run the phases, printing the cumulative line after each; returns the
    exit status: 1 when a phase failed."""
    if os.environ.get("BENCH_UNROLL"):
        raise SystemExit(
            "bench_torch: BENCH_UNROLL has no counterpart in the port (bench.py's batch_unroll "
            "unrolls lax.scan; the port's window loop is a Python loop); unset it"
        )
    device = bench_device()

    from hdenseunet_tpu_torch.core.config import InferConfig
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    preset = os.environ.get("BENCH_PRESET", "full")
    z = int(os.environ.get("BENCH_Z", "192"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    size = 512 if preset == "full" else 64

    def emit():
        print(json.dumps(line), flush=True)

    cfg = InferConfig(
        input_size=size,
        window_batch=int(os.environ.get("BENCH_WINDOW_BATCH", "8")),
    )
    model = init_model(HDenseUNet(preset=preset, device=device), 0)
    scorer = DeviceVolumeScorer(
        model, dataclasses.replace(cfg, shared_2d=os.environ.get("BENCH_SHARED2D", "0") == "1"),
        arch="end2end", compute_dtype="bfloat16", device=device,
    )
    vol, mini_z, maxi_z = volume_case(size, z)

    _note("infer: warmup")
    scorer.summarize(vol, mini_z, maxi_z)
    _note("infer: timed end-to-end reps")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        digest = scorer.summarize(vol, mini_z, maxi_z)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    assert np.all(np.isfinite(digest)), digest

    flops = scorer.estimate_flops(vol.shape, mini_z, maxi_z)
    peak = peak_flops(device)
    line = {
        "metric": "hybrid_inference_volume_latency",
        "value": round(dt, 3),
        "unit": "s/volume",
        "vs_baseline": round(BASELINE_SEC_PER_VOLUME / max(dt, 1e-9), 2),
        "model_tflops": round(flops / 1e12, 2),
        "achieved_tflops": round(flops / dt / 1e12, 2),
        "mfu": round(flops / dt / peak, 4),
        **card_keys(device),
    }
    emit()

    def compute_phase():
        k_small = 1
        k_big = int(os.environ.get("BENCH_COMPUTE_K", "5"))
        c_reps = int(os.environ.get("BENCH_COMPUTE_REPS", "8"))
        timed = scorer.compute_timer(vol, mini_z, maxi_z)
        _note(f"infer: warming slope endpoints k={k_small},{k_big}")
        timed(k_small), timed(k_big)
        _note("infer: interleaved slope reps")
        sl = hardened_slope(lambda: timed(k_small), lambda: timed(k_big), k_small, k_big, c_reps)
        out = {
            "compute_spread": round(sl["spread"], 3),
            "compute_t_small_s": round(sl["t_small_min"], 3),
            "compute_t_big_s": round(sl["t_big_min"], 3),
            "compute_k_big": k_big,
        }
        if sl["unreliable"]:
            out["compute_unreliable"] = True
        else:
            out["compute_s_per_volume"] = round(sl["slope"], 3)
            out["compute_mfu"] = round(flops / out["compute_s_per_volume"] / peak, 4)
        return out

    if os.environ.get("BENCH_COMPUTE", "1") == "1":
        fenced(line, "compute", compute_phase)
        emit()

    # Attribution of the headline (value ~= compute + h2d + dispatch); each
    # timed region ends in a fetch, so h2d_s overstates the copy by about
    # dispatch_s.
    zw = scorer.plan(vol.shape, mini_z, maxi_z)["zw"]
    host_wire = torch.zeros((size, size, zw), dtype=torch.bfloat16)
    one = torch.ones((), device=device)

    def t_dispatch():
        t0 = time.perf_counter()
        (one * 1.0000001).item()
        return time.perf_counter() - t0

    def t_h2d():
        t0 = time.perf_counter()
        dev = host_wire.to(device)
        dev[0, 0, 0].item()  # the copy has completed
        return time.perf_counter() - t0

    t_dispatch(), t_h2d()  # warm
    line.update({
        "dispatch_s": round(min(t_dispatch() for _ in range(3)), 3),
        "h2d_s": round(min(t_h2d() for _ in range(3)), 3),
        "wire_mb": round(host_wire.numel() * host_wire.element_size() / 1e6, 1),
    })
    if "compute_s_per_volume" in line:
        line["decomp_gap_s"] = round(
            dt - (line["compute_s_per_volume"] + line["h2d_s"] + line["dispatch_s"]), 3
        )
    emit()

    if os.environ.get("BENCH_PIPELINE", "1") == "1" and not scorer.shared_2d:
        _note("pipelined multi-volume loop")
        fenced(line, "pipelined", lambda: measure_pipelined(
            scorer.model, cfg, preset, vol, mini_z, maxi_z, device))
        emit()

    if os.environ.get("BENCH_TRAIN", "1") == "1":
        fenced(line, "train", lambda: measure_train(preset, device))
        emit()

    return 1 if any(k.endswith("_error") for k in line) else 0


if __name__ == "__main__":
    sys.exit(main())
