"""What every run of the benchmark shares: its spans, the card's identity,
the reading of a profiler trace, the correctness readings and the result
line.

Spans are the harness's own: host-clock intervals around its calls into the
program's entry points, kept in memory (:class:`Spans`). In a traced run
each span is also a ``torch.profiler.record_function`` scope, so the trace
names what the host was doing during each idle gap of the device
(:func:`reduce_trace`).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "hdenseunet_tpu")
TOP_N = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host-clock intervals. ``traced`` also opens a profiler scope
    of the same name around each."""

    def __init__(self):
        self.totals: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        scope = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with scope:
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device, chips: int) -> dict:
    """The contract's ``device`` keys for the run so far."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, window: str = "traced_window") -> dict:
    """From a Chrome trace's events: the traced window (the scope named
    ``window``), the device's busy seconds in it (the union of kernels,
    copies and memsets), the device seconds by operation name, and the idle
    seconds by the innermost host scope open at each idle gap's middle
    ("none" where no scope was open)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"no {window!r} scope in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    by_name: dict = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t > s:
            dev.append((s, t))
            by_name[e["name"]] += (t - s) * 1e-6
    busy = _union(dev)
    scopes = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") != window),
    )
    gaps: dict = defaultdict(float)
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        inner = [sc for sc in scopes if sc[0] <= mid <= sc[1]]
        label = min(inner, key=lambda sc: sc[1] - sc[0])[2] if inner else "none"
        gaps[label] += (t - s) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "device_ops": dict(by_name),
        "idle_by_scope": dict(gaps),
    }


def top(d: dict, n: int = TOP_N) -> list:
    return [[name[:120], v] for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(spans: Spans, device, out_dir: str):
    """Profile the block (host and device) into ``out_dir`` and yield a dict
    that holds :func:`reduce_trace`'s summary once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    summary: dict = {}
    spans.traced = True
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("traced_window"):
                yield summary
            synchronize(device)
    finally:
        spans.traced = False
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    summary.update(reduce_trace(events))


# --------------------------------------------------------------------------
# correctness readings
# --------------------------------------------------------------------------


def relative_gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| over max(|ref|, floor)."""
    return abs(prog - ref) / max(abs(ref), floor)


class Checks:
    """Numbers compared, each beside its limit; ``ok`` when every number is
    at or under its limit and finite."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}

    def put(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        old = self.values.get(name)
        self.values[name] = value if old is None or not value <= old else old

    @property
    def ok(self) -> bool:
        return bool(self.values) and all(
            v == v and v <= self.limits[k] for k, v in self.values.items()
        ) and set(self.values) == set(self.limits)

    def record(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]} for k in self.limits}

    def lines(self) -> list:
        return [f"check {k}: {self.values.get(k)!r} (limit {self.limits[k]!r})" for k in self.limits]


def emit(result: dict, checks: Checks) -> None:
    """The checks as the last lines of stderr, then the result line, with
    the checks under a key that comes last, as stdout's last line."""
    for line in checks.lines():
        print(line, file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks.record()
    print(json.dumps(result), flush=True)
