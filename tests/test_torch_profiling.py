"""The port's tracing and timing tools on the CPU: ``utils/profiling.py``
against the JAX package's, the serving stages' scopes on a trace, and the
scorer's timing helpers (``compute_timer``, ``compute_seconds``)."""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from hdenseunet_tpu.utils import profiling as JP
from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from hdenseunet_tpu_torch.utils import profiling as TP


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _trace_text(logdir) -> str:
    files = sorted(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    text = files[0].read_text()
    json.loads(text)  # a whole JSON document, as Perfetto and chrome://tracing read it
    return text


def test_trace_names_an_annotated_scope(tmp_path):
    with TP.trace(tmp_path / "trace", device="cpu") as prof:
        with TP.annotate("unit-test-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "unit-test-region" in _trace_text(tmp_path / "trace")
    assert any(e.name == "unit-test-region" for e in prof.events())


def test_segment_trace_names_the_serving_stages(tmp_path):
    """One VolumePredictor.segment inside a trace: scoring, fetch and the
    host postprocess appear as scopes, around the model's operators."""
    cfg = Config()
    cfg.model.preset = "tiny"
    cfg.infer = InferConfig(window_batch=2)
    predictor = VolumePredictor(init_model(HDenseUNet(preset="tiny"), 0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    vol = rng.integers(-200, 251, (32, 32, 24)).astype(np.float32)
    ext = np.zeros(vol.shape, np.int16)
    ext[8:24, 8:24, 6:18] = 1
    with TP.trace(tmp_path, device="cpu"):
        lab = predictor.segment(vol, ext)
    assert lab.shape == vol.shape
    text = _trace_text(tmp_path)
    for scope in ("scoring", "fetch", "postprocess", "aten::convolution"):
        assert f'"{scope}"' in text, scope


@pytest.mark.parametrize("window", [200, 3])
def test_step_timer_matches_jax(window, monkeypatch):
    """Under one patched clock both timers give the same statistics; JAX
    divides the per-chip rate by jax.device_count() (8 on the tests' virtual
    CPU mesh), the port's step runs on one device."""
    import jax

    ticks = [0.0, 0.1, 0.25, 0.31, 0.52, 0.60, 0.95, 1.0]
    monkeypatch.setattr(JP.time, "perf_counter", iter(ticks).__next__)
    want = JP.StepTimer(window=window)
    for _ in ticks:
        want.tick()
    monkeypatch.setattr(TP.time, "perf_counter", iter(ticks).__next__)
    got = TP.StepTimer(window=window)
    for _ in ticks:
        got.tick()
    n_dev = jax.device_count()
    a, b = want.stats(samples_per_step=8), got.stats(samples_per_step=8)
    assert a.keys() == b.keys()
    for key in ("steps_per_sec", "p50_ms", "p95_ms"):
        assert b[key] == pytest.approx(a[key], rel=1e-12), key
    assert n_dev == 8
    assert b["samples_per_sec_per_chip"] == pytest.approx(a["samples_per_sec_per_chip"] * n_dev, rel=1e-12)


def test_step_timer_empty_and_rolling(monkeypatch):
    t = TP.StepTimer(window=2)
    assert t.stats() == {}
    monkeypatch.setattr(TP.time, "perf_counter", itertools.count(0.0, 0.5).__next__)
    for _ in range(5):
        t.tick()
    assert t._times == [0.5, 0.5] and t.stats()["p50_ms"] == pytest.approx(500.0)


MODES = {"dedup-2D": {}, "per-window": dict(dedup_2d=False), "shared-2D": dict(shared_2d=True)}


@pytest.fixture(scope="module")
def tiny_model():
    return init_model(HDenseUNet(preset="tiny"), 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_timed_program_is_the_served_one(tiny_model, mode):
    """``timed(k)`` gives positive seconds, and the digest it ends on equals
    ``summarize`` of the served ``score``, bit for bit."""
    cfg = dataclasses.replace(InferConfig(), **MODES[mode])
    scorer = DeviceVolumeScorer(tiny_model, cfg, device="cpu")
    vol = np.random.default_rng(1).normal(0, 50, (32, 32, 28)).astype(np.float32)
    timed = scorer.compute_timer(vol, 4, 20)
    assert timed(1) > 0 and timed(2) > 0
    np.testing.assert_array_equal(timed.digest, scorer.summarize(vol, 4, 20))
    np.testing.assert_array_equal(
        timed.digest, scorer.score(vol, 4, 20, output="digest").numpy()
    )


def test_compute_seconds_is_the_slope(tiny_model, monkeypatch):
    scorer = DeviceVolumeScorer(tiny_model, InferConfig(), device="cpu")
    vol = np.random.default_rng(2).normal(0, 50, (32, 32, 20)).astype(np.float32)
    assert scorer.compute_seconds(vol, 2, 16, k_small=1, k_big=2, reps=1) > 0
    d = scorer.compute_seconds(vol, 2, 16, k_small=1, k_big=3, reps=2, detail=True)
    assert d.keys() == {"seconds", "slopes", "t_small", "t_big"}
    assert d["t_small"] == sorted(d["t_small"]) and len(d["t_big"]) == 2
    assert d["seconds"] == d["slopes"][0] == max((d["t_big"][0] - d["t_small"][0]) / 2, 1e-9)

    # the slope of fixed per-call timings, warm-up calls excluded
    calls = []

    def fake_timer(*_):
        def timed(k):
            calls.append(k)
            return 5.0 if len(calls) <= 2 else 0.25 + 0.5 * k + 0.01 * len(calls)
        return timed

    monkeypatch.setattr(scorer, "compute_timer", fake_timer)
    d = scorer.compute_seconds(vol, 2, 16, k_small=1, k_big=3, reps=2, detail=True)
    assert calls == [1, 3, 1, 1, 3, 3]
    assert d["t_small"] == [0.78, 0.79] and d["t_big"] == [pytest.approx(1.80), pytest.approx(1.81)]
    assert d["seconds"] == pytest.approx(0.51)
