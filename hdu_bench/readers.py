"""What the per-layer readers in ``metrics/`` share. A reader reads a run
only where the run reports the end-to-end metric that the reader's metric
moves (its ``MOVES``), and returns None where it finds nothing to read."""
from __future__ import annotations


def per_unit(run: dict, moves: str, span: str, scale: float = 1.0):
    """The harness's host seconds in ``span`` over the window's volumes or
    steps, times ``scale``."""
    if moves not in run.get("metrics", {}) or span not in run.get("spans", {}):
        return None
    return scale * run["spans"][span] / run["count"]


def idle_pct(run: dict, moves: str):
    """Share of the traced window in which no kernel, copy or memset ran on
    the card (the profiler's device timeline)."""
    if moves not in run.get("metrics", {}) or "trace" not in run:
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run: dict, moves: str, seconds_per_unit: float):
    """The work's FLOPs a volume or a step (``run["work"]["flops"]``) over
    the window's wall seconds a volume or step (the metric's value times
    ``seconds_per_unit``), as a share of the card's dense bfloat16 peak."""
    peaks = run.get("work", {}).get("peaks")
    if moves not in run.get("metrics", {}) or not peaks:
        return None
    return 100.0 * run["work"]["flops"] / (run["metrics"][moves] * seconds_per_unit) / peaks["bf16_flops"]
