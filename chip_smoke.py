#!/usr/bin/env python3
"""Drive the PyTorch port (hdenseunet_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each (the script catches nothing; any failure
exits non-zero):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   raises without a card;
2. build of the port's CUDA kernels from csrc/;
3. K1 (affine_relu) against its plain PyTorch version at the serving path's
   shapes, bf16 and fp32, on both its vector and scalar paths, with times;
4. the main path: VolumePredictor.segment on two synthetic 512x512x96 CT
   volumes, full-preset H-DenseUNet in bfloat16 with seeded random weights,
   counting K1 launches;
5. model-level check of the kernel path: the tiny-preset scorer in float32
   on the CPU (plain path) and on the card (K1 path) agree;
then a JSON line describing the kernels, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import subprocess
import time

import numpy as np
import torch

SEED = 0
VOLUME_SHAPE = (512, 512, 96)
LIVER_Z = (20, 76)  # synthetic liver mask covers z 20..75
HU_RANGE = (-200, 250)  # the preprocessing window (DataConfig.hu_window)
# ≤ 1 ulp of the result in the working dtype, plus one fp32 ulp of x*A for the
# kernel's fused multiply-add against the plain version's separate mul and add
ULP_FP32 = 2.0**-23
# CPU float32 vs cuDNN float32 (TF32 off): the same arithmetic summed in
# another order through ~60 conv layers, probabilities in [0, 1]
MODEL_TOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(card: str) -> dict:
    from hdenseunet_tpu_torch.ops import fused_affine as K

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (label, JAX-layout shape (..., C), dtype, relu)
        ("2d conv1 36x256x256x96", (36, 256, 256, 96), torch.bfloat16, True),
        ("2d block1 36x128x128x384", (36, 128, 128, 384), torch.bfloat16, True),
        ("3d 8x128x128x2x192", (8, 128, 128, 2, 192), torch.bfloat16, True),
        ("fp32 36x128x128x96", (36, 128, 128, 96), torch.float32, True),
        ("fp32 no-relu 8x64x64x35", (8, 64, 64, 35), torch.float32, False),
        ("odd C 36x64x64x36", (36, 64, 64, 36), torch.bfloat16, True),
        ("unaligned rows 4096x96", (4096, 96), torch.bfloat16, True),
    ]
    paths = set()
    worst = 0.0
    times = {}
    for label, shape, dtype, relu in cases:
        c = shape[-1]
        if label.startswith("unaligned"):
            flat = torch.randn(int(np.prod(shape)) + 1, device="cuda", generator=gen)
            x = flat.to(dtype)[1:].view(shape)  # storage offset: 2-byte aligned
        else:
            x = (2 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
        x = x.movedim(-1, 1)  # PyTorch shape, channels-last memory
        scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
        shift = 0.5 * torch.randn(c, device="cuda", generator=gen)
        got = K.affine_relu(x, scale, shift, relu=relu)
        want = K.affine_relu_reference(x, scale, shift, relu=relu)
        torch.cuda.synchronize()
        a = scale.to(dtype).float().view([1, -1] + [1] * (x.dim() - 2))
        bound = (
            torch.finfo(dtype).eps * want.float().abs()
            + ULP_FP32 * (x.float() * a).abs()
            + torch.finfo(dtype).tiny
        )
        diff = (got.float() - want.float()).abs()
        assert got.stride() == x.stride(), (label, got.stride(), x.stride())
        assert bool((diff <= bound).all()), f"K1 disagrees at {label}: max {diff.max()}"
        err = float(diff.max())
        worst = max(worst, err)
        path = "vector" if K.vector_path(x, got, a.flatten(), a.flatten()) else "scalar"
        paths.add(path)
        t = [
            cuda_ms(lambda: K.affine_relu_reference(x, scale, shift, relu=relu)),
            cuda_ms(lambda: K.affine_relu(x, scale, shift, relu=relu)),
            cuda_ms(lambda: K.affine_relu(x, scale, shift, relu=relu)),
            cuda_ms(lambda: K.affine_relu_reference(x, scale, shift, relu=relu)),
        ]
        times[label] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
        gbps = 2 * x.numel() * x.element_size() / (times[label][0] * 1e-3) / 1e9
        print(
            f"K1 {label} {str(dtype)[6:]} {path}: max_abs_err {err:.3g}, "
            f"kernel {times[label][0]:.4f} ms ({gbps:.0f} GB/s), "
            f"plain {times[label][1]:.4f} ms [{card}]"
        )
    assert paths == {"vector", "scalar"}, paths
    k_ms, p_ms = times[cases[0][0]]
    return dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms)


def synthetic_case(seed: int):
    """A CT volume of integer HU in the preprocessing window and an external
    liver mask, both (X, Y, Z)."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(HU_RANGE[0], HU_RANGE[1] + 1, VOLUME_SHAPE).astype(np.float32)
    ext = np.zeros(VOLUME_SHAPE, np.int16)
    ext[150:370, 120:360, LIVER_Z[0] : LIVER_Z[1]] = 1
    ext[230:260, 200:230, 40:50] = 2  # a tumor label, merged into the mask
    return vol, ext


def main_path(card: str) -> int:
    from hdenseunet_tpu_torch._reuse import Config, postprocess
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models import layers as L
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    model = init_model(HDenseUNet(preset=cfg.model.preset, device="cuda"), SEED)
    bsr_per_forward = sum(isinstance(m, L.Scale) for m in model.modules())
    predictor = VolumePredictor(model, cfg, arch="end2end", device="cuda")
    cases = [synthetic_case(SEED + i) for i in range(2)]
    runs = 0
    for vol, ext in cases:
        _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
        plan = predictor.windows.plan(vol.shape, z_lo, z_hi)
        runs += int((plan["weights"].sum(axis=1) > 0).sum())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    affine_relu.launches = 0
    seconds, labelmaps = [], []
    for vol, ext in cases:
        t0 = time.perf_counter()
        labelmaps.append(predictor.segment(vol, ext))
        seconds.append(time.perf_counter() - t0)
    launches = affine_relu.launches
    peak = torch.cuda.max_memory_allocated()

    assert launches >= bsr_per_forward * runs, (launches, bsr_per_forward, runs)
    for (vol, _), lab in zip(cases, labelmaps):
        assert lab.dtype == np.uint8 and lab.shape == vol.shape, (lab.dtype, lab.shape)
        assert set(np.unique(lab).tolist()) <= {0, 1, 2}, np.unique(lab)
    vol, ext = cases[0]
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    probs = predictor.windows.score(vol - cfg.infer.mean, z_lo, z_hi)
    assert bool(torch.isfinite(probs).all()), "non-finite scores"
    assert float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0 + 1e-5
    counts = [np.bincount(lab.ravel(), minlength=3).tolist() for lab in labelmaps]
    host_pp = "native" if postprocess.native.pp_available() else "scipy"
    print(
        f"main path: 2 volumes {VOLUME_SHAPE} full preset bf16, {runs} window runs, "
        f"s/volume {[round(s, 3) for s in seconds]}, peak {peak / 2**30:.2f} GiB, "
        f"K1 launches {launches} (>= {bsr_per_forward} x {runs}), "
        f"label counts {counts}, host postprocess {host_pp} [{card}]"
    )
    return launches


def model_check(card: str) -> float:
    from hdenseunet_tpu_torch._reuse import InferConfig
    from hdenseunet_tpu_torch.core.initializers import init_model
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from hdenseunet_tpu_torch.ops.fused_affine import affine_relu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = InferConfig()
    cpu_model = init_model(HDenseUNet(preset="tiny"), SEED)
    gpu_model = copy.deepcopy(cpu_model)
    vol = np.random.default_rng(SEED).normal(0, 50, (64, 64, 28)).astype(np.float32)
    want = DeviceVolumeScorer(cpu_model, cfg, device="cpu").score(vol, 4, 20).numpy()
    before = affine_relu.launches
    got = DeviceVolumeScorer(gpu_model, cfg, device="cuda").score(vol, 4, 20).cpu().numpy()
    assert affine_relu.launches > before, "the card's scorer did not run K1"
    err = float(np.abs(got - want).max())
    assert err <= MODEL_TOL, err
    print(f"model check: tiny fp32 scorer, card (K1) vs CPU (plain) max_abs_err {err:.3g} [{card}]")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")

    from hdenseunet_tpu_torch.ops import build

    so, seconds = build.build()
    print(f"build: {so.name} in {seconds:.1f} s")

    k1 = check_k1(card)
    launches = main_path(card)
    model_check(card)
    kernels = [{
        "name": "affine_relu",
        "route": "cuda",
        "source": "hdenseunet_tpu_torch/csrc/fused_affine.cu",
        "replaces": "hdenseunet_tpu/ops/fused_affine.py:48",
        "launches": launches,
        **k1,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
