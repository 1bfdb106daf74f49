"""The benchmark's readers of the program's spans and counters
(``hdu_bench/recorder.py`` and twelve files in ``hdu_bench/metrics/``) on
made-up snapshots: their values, and None wherever there is nothing to
read."""
from __future__ import annotations

import sys
import types

import pytest

from hdu_bench import recorder
from hdu_bench import run as RUN

SNAPSHOT = {
    "spans": {
        "mask_extent": dict(count=3, total_s=3.3, self_s=3.3, syncs=0),
        "scoring": dict(count=3, total_s=2.7, self_s=0.6, syncs=0),
        "upload": dict(count=3, total_s=0.3, self_s=0.3, syncs=6),
        "window_batch": dict(count=27, total_s=1.8, self_s=1.8, syncs=54),
        "fetch": dict(count=3, total_s=0.4, self_s=0.4, syncs=3),
        "forward": dict(count=12, total_s=1.2, self_s=1.2, syncs=0),
        "backward": dict(count=12, total_s=2.4, self_s=2.4, syncs=0),
        "put": dict(count=12, total_s=0.1, self_s=0.1, syncs=3),
    },
    "counts": {"window_batches": 27, "stacks_2d": 540, "mask_box_voxels": 52297596, "bn_live": 966,
               "dropout": 3},
}
WANT = {  # over 3 traced units
    "mask_extent_s.serve": 1.1, "scoring_s.serve": 0.9, "syncs.serve": 22.0,
    "forward_ms.eager": 400.0, "backward_ms.eager": 800.0, "syncs.eager": 22.0, "syncs.graphed": 22.0,
    "window_batches.serve": 9.0, "stacks_2d.serve": 180.0, "mask_box_voxels.serve": 17432532.0,
    "bn_live_calls.eager": 322.0, "dropout_calls.eager": 1.0,
}


@pytest.fixture
def readers():
    found = RUN.metric_readers()
    assert set(WANT) <= set(found)
    return {name: found[name] for name in WANT}


def _program(monkeypatch, snapshot=SNAPSHOT):
    """The program's recorder module, holding ``snapshot`` (or none)."""
    mod = types.ModuleType(recorder.PROGRAM)
    if snapshot is not None:
        mod.snapshot = lambda: snapshot
    monkeypatch.setitem(sys.modules, recorder.PROGRAM, mod)


def _run(reader, platform="gpu", **changes):
    run = {"metrics": {reader.MOVES: 1.0}, "trace": {"busy_s": 1.0, "window_s": 2.0},
           "traced_units": 3, "device": {"platform": platform}}
    run.update(changes)
    return run


def test_readers_divide_the_snapshot_by_the_traced_units(readers, monkeypatch):
    _program(monkeypatch)
    for name, reader in readers.items():
        assert reader.read(_run(reader)) == pytest.approx(WANT[name]), name


@pytest.mark.parametrize("case", ["no_moves", "no_trace", "no_program", "no_recorder", "span_missing"])
def test_readers_find_nothing(readers, monkeypatch, case):
    """None where the run reports another end-to-end metric, has no trace,
    runs the control (the program not loaded), runs a program without the
    recorder, or where the span or counter was never opened."""
    if case == "no_program":
        monkeypatch.delitem(sys.modules, recorder.PROGRAM, raising=False)
    else:
        _program(monkeypatch, None if case == "no_recorder" else
                 {"spans": {}, "counts": {}} if case == "span_missing" else SNAPSHOT)
    for name, reader in readers.items():
        run = _run(reader)
        if case == "no_moves":
            run["metrics"] = {"some_other_metric": 1.0}
        elif case == "no_trace":
            del run["trace"]
        assert reader.read(run) is None, (case, name)


def test_sync_readers_read_nothing_off_the_card(readers, monkeypatch):
    _program(monkeypatch)
    for name, reader in readers.items():
        value = reader.read(_run(reader, platform="cpu"))
        assert (value is None) == name.startswith("syncs."), name
