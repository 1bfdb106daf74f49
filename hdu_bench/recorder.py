"""What the readers of the program's own spans and counters share. The
program records them (``hdenseunet_tpu_torch.utils.profiling``) only while
a profiler session is open, and a run opens one, the traced segment, so its
``snapshot()`` is that segment's. A reader returns None where the run does
not report its ``MOVES`` metric or has no trace, where the program is not
loaded (``--control 1``) or keeps no recorder, and, for syncs, where the
device is not a card."""
from __future__ import annotations

import sys

PROGRAM = "hdenseunet_tpu_torch.utils.profiling"


def snapshot(run: dict, moves: str, card_only: bool = False):
    """The program's recorder snapshot for a traced run, or None."""
    if moves not in run.get("metrics", {}) or "trace" not in run or not run.get("traced_units"):
        return None
    if card_only and run.get("device", {}).get("platform") != "gpu":
        return None
    read = getattr(sys.modules.get(PROGRAM), "snapshot", None)
    return read() if read is not None else None


def span_per_unit(run: dict, moves: str, span: str, scale: float = 1.0):
    """Host seconds inside the program's span ``span`` over the traced
    volumes or steps, times ``scale``."""
    snap = snapshot(run, moves)
    if snap is None or span not in snap["spans"]:
        return None
    return scale * snap["spans"][span]["total_s"] / run["traced_units"]


def syncs_per_unit(run: dict, moves: str):
    """Host-blocking CUDA synchronisations made inside the program's spans
    over the traced volumes or steps."""
    snap = snapshot(run, moves, card_only=True)
    if snap is None or not snap["spans"]:
        return None
    return sum(s["syncs"] for s in snap["spans"].values()) / run["traced_units"]


def count_per_unit(run: dict, moves: str, name: str):
    """The program's counter ``name`` over the traced volumes or steps."""
    snap = snapshot(run, moves)
    if snap is None or name not in snap["counts"]:
        return None
    return snap["counts"][name] / run["traced_units"]
