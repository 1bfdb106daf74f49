"""Tracing and step timing (counterpart of hdenseunet_tpu/utils/profiling.py).

* :func:`trace`: ``torch.profiler`` over a block, written as a
  Chrome/Perfetto JSON trace (host operators and, on the card, its kernels
  and copies);
* :func:`annotate`: a named scope on that timeline
  (``torch.profiler.record_function``), for host phases such as scoring,
  the fetch and the postprocess;
* :class:`StepTimer`: host-clock step statistics (p50/p95, steps/s,
  samples/s per device) with no device sync per step.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """Profile the enclosed block into ``logdir`` (created if missing) as
    ``<host>_<pid>.<ns>.pt.trace.json``. CUDA and host activity on the
    card; host activity alone when ``device`` is the CPU. Yields the
    ``torch.profiler.profile``, readable (``events()``,
    ``key_averages()``) once the block has closed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))
    ) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)


def annotate(name: str):
    """Named scope that appears on the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step-time statistics without per-step device syncs.

    Call :meth:`tick` once per dispatched step; the buckets are host wall
    clock between ticks, so once the queue of work fills they measure the
    device's throughput. A step runs on one device (the JAX package divides
    by ``jax.device_count()``), so ``samples_per_sec_per_chip`` is the
    step's own rate.
    """

    def __init__(self, window: int = 200):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self, samples_per_step: int = 1) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps_per_sec": 1.0 / t.mean(),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "samples_per_sec_per_chip": samples_per_step / t.mean(),
        }
