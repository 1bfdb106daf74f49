#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one CUDA card.

    python3 profile_train.py [--steps 3] [--pairs 2] [--trace PATH] [--steps-per-dispatch 8]

Runs chip_smoke.py's training configuration (full preset, bfloat16, global
batch 8, remat, seeded random weights, synthetic batches) for the end2end
and the 2D stage, and prints one line per measurement, each with the card's
name and power limit:

1. per stage, the step's wall time (``train_step`` then
   ``torch.cuda.synchronize``) and the host time to queue it (before the
   sync), after two warm-up steps;
2. per stage, one step under ``torch.profiler``: device time by kernel,
   device busy time, the device's idle share of the step wall, device events
   per step, the share of the port's own kernels (K1 forward and backward,
   K2 forward and backward) and each of them by name, the host's operators
   by self CPU time, and the host self time of the port's four autograd
   wrappers per call;
3. the host time per call of each of the port's four training kernel
   wrappers alone, at one end2end step shape, and of K5's at a served
   shape, with the card held busy so that no call waits on it: the
   wrapper's Python, ctypes and launch cost, which the profiler's self time
   of the autograd wrappers mixes with remat's recompute;
4. the end2end step with the kernels against the step with their plain
   PyTorch versions, in turns (plain, kernels, kernels, plain per pair). The
   plain versions are switched on here only, by pointing the wrappers'
   module names at them; the package itself has no such switch. The launch
   counters show which ran;
5. per stage, the step as it runs (cuDNN restricted to deterministic
   algorithms, ``trainer.repeatable``) against the step with cuDNN free to
   choose, in turns (free, deterministic, deterministic, free per pair);
   the free form is switched on here only, by pointing
   ``trainer.repeatable`` at a null context;
6. with ``--steps-per-dispatch K`` (K > 1), per stage, the graphed step:
   ``make_multi_step`` over one stacked group of K synthetic batches, a
   first call (eager: the warm-up), a second (the capture, then K
   replays), then ``--steps`` calls timed: wall and host queueing per step;
   then one call under torch.profiler (device events): device busy ms a
   step and the idle share of its wall, beside the eager step's of item 2;
   then a second graph, captured with cuDNN free to choose, against the
   first in turns (free, deterministic, deterministic, free per pair).

It raises without a card and catches nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

from chip_smoke import SEED, card_line, device_busy_ms

OWN = ("affine_relu", "wce_")  # name fragments of the port's CUDA kernels
# the profiler's names of the port's autograd Functions and their backwards
WRAPPERS = ("AffineReLU", "AffineReLUBackward", "WeightedCE", "WeightedCEBackward")


def make_state(arch: str):
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.parallel.multihost import put_batch
    from hdenseunet_tpu_torch.train.trainer import create_train_state

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.train.arch, cfg.train.batch, cfg.train.remat = arch, 8, True
    state = create_train_state(cfg, arch, device="cuda", seed=SEED)
    gen = synthetic_batches(
        mode="2d" if arch == "2d" else "hybrid", batch=8, input_size=cfg.model.input_size,
        input_cols=cfg.model.input_cols, seed=SEED,
    )
    host = next(gen)
    batch = put_batch(host, "cuda")  # one batch, already on the card
    return state, cfg, batch, host


def step_times(state, cfg, batch, steps: int) -> tuple[list, list]:
    """(wall ms, host queueing ms) per step."""
    from hdenseunet_tpu_torch.train.trainer import train_step

    walls, queued = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, cfg)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls.append((t2 - t0) * 1e3)
        queued.append((t1 - t0) * 1e3)
    return walls, queued


def profile_step(state, cfg, batch, arch: str, card: str, trace: str | None) -> None:
    from hdenseunet_tpu_torch.train.trainer import train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += 1
            by_kernel[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_kernel.values())
    own = sum(ms for name, (_, ms) in by_kernel.items() if any(f in name for f in OWN))
    events = sum(n for n, _ in by_kernel.values())
    print(
        f"profiled {arch} step: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle {100 * (1 - busy_ms / 1e3 / wall):.1f} % of the step wall, {events} device events, "
        f"the port's kernels {own:.2f} ms ({100 * own / busy_ms:.1f} % of busy) [{card}]"
    )
    for name, (n, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % x{n:<6d} {name[:110]}")
    print(f"  the port's kernels (profiled step) [{card}]:")
    for name, (n, ms) in sorted(by_kernel.items()):
        if any(f in name for f in OWN):
            print(f"  {ms:9.3f} ms x{n:<6d} {name[:110]}")
    averages = prof.key_averages()
    print(f"  host ops by self CPU time (profiled step) [{card}]:")
    for a in sorted(averages, key=lambda a: -a.self_cpu_time_total)[:12]:
        print(f"  {a.self_cpu_time_total / 1e3:9.2f} ms x{a.count:<6d} {a.key[:100]}")
    print(f"  the port's wrappers, host self time (profiled step) [{card}]:")
    for a in averages:
        if a.key in WRAPPERS:
            print(f"  {a.self_cpu_time_total / 1e3:9.2f} ms x{a.count:<6d} "
                  f"{a.self_cpu_time_total / a.count:8.1f} us/call {a.key}")
    if trace:
        path = f"{trace}.{arch}.json"
        prof.export_chrome_trace(path)
        print(f"trace: {path}")


def wrapper_host_us(card: str, calls: int = 200) -> None:
    """Host microseconds per call of K1 forward and backward on a
    channels-last 64x192x7x7 bf16 tensor (block 4's bottleneck BN), of K2
    forward and backward on 401,408 rows and of K5 at 2D stage 5's last
    served bottleneck (9,216 rows, K 2160 of a 2208-wide buffer, N 192),
    while a sleep kernel holds the stream, so that the host never waits on
    the card."""
    from hdenseunet_tpu_torch.ops import affine_gemm as K5, fused_affine as K, wce as W

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((64, 7, 7, 192), device="cuda", generator=gen).to(torch.bfloat16).movedim(-1, 1)
    g = torch.randn((64, 7, 7, 192), device="cuda", generator=gen).to(torch.bfloat16).movedim(-1, 1)
    a, b = torch.rand(192, device="cuda", generator=gen), torch.randn(192, device="cuda", generator=gen)
    y = K.affine_relu(x, a, b)
    n = 8 * 224 * 224
    logits = torch.randn((n, 3), device="cuda", generator=gen).to(torch.bfloat16)
    labels = torch.randint(0, 3, (n,), device="cuda", generator=gen, dtype=torch.int32)
    mask, w = torch.ones(n, device="cuda"), torch.tensor((0.78, 0.65, 8.57), device="cuda")
    _, cnt = W.wce_forward(logits, labels, mask, w)
    one = torch.ones((), device="cuda")
    buf = torch.randn((9216, 2208), device="cuda", generator=gen).to(torch.bfloat16)
    xk = buf[:, :2160].view(1, 9216, 1, 2160).movedim(-1, 1)
    wk = (torch.randn((192, 2160), device="cuda", generator=gen) / 48).to(torch.bfloat16)
    pairs = [torch.rand(c, device="cuda", generator=gen) for c in (2160, 2160, 192, 192)]
    wrappers = {
        "affine_relu": lambda: K.affine_relu(x, a, b),
        "affine_relu_backward": lambda: K.affine_relu_backward(g, x, a, y),
        "wce_forward": lambda: W.wce_forward(logits, labels, mask, w),
        "wce_backward": lambda: W.wce_backward(logits, labels, mask, w, cnt, one),
        "affine_gemm": lambda: K5.affine_gemm(xk, wk, *pairs),
    }
    us = {}
    for name, fn in wrappers.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # ~50 ms: longer than the calls take to queue
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    print(f"wrapper host time per call, card held busy, {calls} calls each: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()) + f" [{card}]")


def graph_times(state, cfg, host: dict, arch: str, k: int, calls: int, pairs: int, card: str) -> None:
    """Item 6: the graphed step of ``state``'s stage, K steps a call; then
    a second graph captured with cuDNN free to choose, and the two in turns
    (free, deterministic, deterministic, free per pair), one call a turn."""
    from hdenseunet_tpu_torch.train.trainer import make_multi_step, stack_batches

    stacked = stack_batches([host] * k)
    multi = make_multi_step(state, cfg, None, k)
    for _ in range(2):  # the eager warm-up group, then the capture and K replays
        multi(stacked)
    torch.cuda.synchronize()

    def timed(fn) -> tuple[float, float]:
        t0 = time.perf_counter()
        fn(stacked)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3, (t1 - t0) / k * 1e3

    walls, queued = zip(*(timed(multi) for _ in range(calls)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        multi(stacked)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, events = device_busy_ms(prof)
    print(
        f"{arch} graphed step (steps_per_dispatch {k}): wall ms/step {[round(w, 2) for w in walls]}, "
        f"host queueing ms/step {[round(q, 2) for q in queued]}, capture {multi.capture_seconds:.2f} s; "
        f"profiled group: wall {wall / k:.2f} ms/step, device busy {busy / k:.2f} ms/step, idle "
        f"{100 * (1 - busy / wall):.1f} %, {events // k} device events a step [{card}]"
    )
    free = make_multi_step(state, cfg, None, k)
    with free_cudnn():
        for _ in range(2):
            free(stacked)
    turns = {"free": [], "deterministic": []}
    for _ in range(pairs):
        for variant in ("free", "deterministic", "deterministic", "free"):
            turns[variant].append(timed(free if variant == "free" else multi)[0])
    for variant, ms in turns.items():
        print(f"{arch} graphed step, cuDNN {variant}: ms/step per turn {[round(m, 2) for m in ms]} [{card}]")


@contextlib.contextmanager
def free_cudnn():
    """Let cuDNN choose its algorithms freely in the train step."""
    from hdenseunet_tpu_torch.train import trainer as T

    saved = T.repeatable
    T.repeatable = contextlib.nullcontext
    try:
        yield
    finally:
        T.repeatable = saved


@contextlib.contextmanager
def plain_versions():
    """Route K1, K1's backward and K2 through their plain PyTorch versions."""
    from hdenseunet_tpu_torch.ops import fused_affine as K, wce as W

    saved = (K.affine_relu, K.affine_relu_backward, W.wce_forward, W.wce_backward)
    K.affine_relu, K.affine_relu_backward = K.affine_relu_reference, K.affine_relu_backward_reference
    W.wce_forward, W.wce_backward = W.weighted_ce_reference, W.weighted_ce_backward_reference
    try:
        yield
    finally:
        K.affine_relu, K.affine_relu_backward, W.wce_forward, W.wce_backward = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="timed steps per stage and per turn")
    ap.add_argument("--pairs", type=int, default=2, help="plain/kernels/kernels/plain turns")
    ap.add_argument("--trace", default=None, help="write each profiled step's chrome trace here")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K > 1: also time and profile the graphed step, K steps a call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch.cuda.is_available() is false; this script needs a card")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}")
    from hdenseunet_tpu_torch.ops import fused_affine as K

    wrapper_host_us(card)
    for arch in ("end2end", "2d"):
        state, cfg, batch, host = make_state(arch)
        step_times(state, cfg, batch, 2)  # warm-up: cuDNN's first calls
        walls, queued = step_times(state, cfg, batch, args.steps)
        print(
            f"{arch} step: wall ms {[round(w, 1) for w in walls]}, host queueing ms "
            f"{[round(q, 1) for q in queued]}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]"
        )
        profile_step(state, cfg, batch, arch, card, args.trace)
        turns = {"free": [], "deterministic": []}
        for _ in range(args.pairs):
            for variant in ("free", "deterministic", "deterministic", "free"):
                with free_cudnn() if variant == "free" else contextlib.nullcontext():
                    step_times(state, cfg, batch, 1)  # cuDNN's first calls in this mode
                    walls, _ = step_times(state, cfg, batch, args.steps)
                turns[variant].append(float(np.median(walls)))
        for variant, ms in turns.items():
            print(f"{arch} step, cuDNN {variant}: median ms per turn {[round(m, 1) for m in ms]} [{card}]")
        if args.steps_per_dispatch > 1:
            graph_times(state, cfg, host, arch, args.steps_per_dispatch, args.steps, args.pairs, card)
        if arch != "end2end":
            del state, batch
            continue
        runs = {"plain": [], "kernels": []}
        for _ in range(args.pairs):
            for variant in ("plain", "kernels", "kernels", "plain"):
                before = K.affine_relu_backward.launches
                with plain_versions() if variant == "plain" else contextlib.nullcontext():
                    walls, _ = step_times(state, cfg, batch, args.steps)
                launched = K.affine_relu_backward.launches - before
                assert (launched == 0) == (variant == "plain"), (variant, launched)
                runs[variant].append(float(np.median(walls)))
        for variant, ms in runs.items():
            print(f"end2end step with the {variant}: median ms per turn {[round(m, 1) for m in ms]} [{card}]")
        del state, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
