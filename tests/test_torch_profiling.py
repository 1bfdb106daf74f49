"""The port's tracing and timing tools on the CPU: ``utils/profiling.py``'s
spans and counters, the serving and training stages' spans on a trace, and
the scorer's timing helpers (``compute_timer``, ``compute_seconds``)."""
import dataclasses
import json
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.infer import postprocess
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


SERVING_SPANS = ("center", "mask_extent", "scoring", "upload", "window_batch", "compose", "fetch",
                 "postprocess")


def _segmented(tmp_path):
    """One VolumePredictor.segment of a tiny volume inside a CPU trace:
    (predictor, labelmap, snapshot, trace text, K3a's launches in it)."""
    from hdenseunet_tpu_torch.ops import score

    cfg = Config()
    cfg.model.preset = "tiny"
    cfg.infer = InferConfig(window_batch=2)
    predictor = VolumePredictor(init_model(HDenseUNet(preset="tiny"), 0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    vol = rng.integers(-200, 251, (32, 32, 24)).astype(np.float32)
    ext = np.zeros(vol.shape, np.int16)
    ext[8:24, 8:24, 6:18] = 1
    before = score.window_accumulate.launches
    out = {}
    snap, text = _spans(tmp_path, lambda: out.update(lab=predictor.segment(vol, ext)))
    assert out["lab"].shape == vol.shape
    return predictor, vol, ext, snap, text, score.window_accumulate.launches - before


def test_segment_trace_names_the_serving_stages(tmp_path):
    """One VolumePredictor.segment inside a trace: the predictor's and the
    scorer's spans appear as scopes, around the model's operators, and
    each records once a volume but the window batches."""
    _, _, _, snap, text, _ = _segmented(tmp_path)
    for scope in SERVING_SPANS + ("aten::convolution",):
        assert f'"{scope}"' in text, scope
    assert {name: s["count"] for name, s in snap["spans"].items() if name != "window_batch"} == {
        name: 1 for name in SERVING_SPANS if name != "window_batch"}
    inner = sum(snap["spans"][n]["total_s"] for n in ("upload", "window_batch", "compose"))
    assert snap["spans"]["scoring"]["self_s"] == pytest.approx(snap["spans"]["scoring"]["total_s"] - inner)


def _grown_box_voxels(mask) -> int:
    """Voxels of the mask's nonzero bounding box grown by one voxel, clipped
    to the volume; 0 for an empty mask."""
    nz = np.nonzero(mask)
    if nz[0].size == 0:
        return 0
    return int(np.prod([min(int(i.max()) + 2, n) - max(int(i.min()) - 1, 0)
                        for i, n in zip(nz, mask.shape)]))


def test_segment_counts_batches_and_stacks(tmp_path):
    """``window_batches`` is K3a's launches (the card's) or the plan's live
    batches (the CPU runs K3a's plain version, uncounted); ``stacks_2d`` the
    dedup batches' 2D stacks; ``mask_box_voxels`` the mask extent's grown
    box."""
    predictor, vol, ext, snap, _, launched = _segmented(tmp_path)
    _, z_lo, z_hi = postprocess.liver_mask_extent(ext)
    plan = predictor.windows.plan(vol.shape, z_lo, z_hi)
    live = int(plan["weights"].any(axis=1).sum())
    wb, cols, stride = plan["wb"], predictor.cfg.infer.input_cols, predictor.cfg.infer.window_stride
    assert plan["dedup"] and live > 1
    assert snap["counts"] == {"window_batches": launched or live,
                              "stacks_2d": live * ((wb - 1) * stride + cols - 2 + 2 * wb),
                              "mask_box_voxels": _grown_box_voxels(ext)}
    assert snap["spans"]["window_batch"]["count"] == live


@pytest.mark.parametrize("route", ["native", "scipy"])
@pytest.mark.parametrize("case", ["inside", "on_faces", "empty"])
def test_mask_extent_counts_its_box(tmp_path, monkeypatch, route, case):
    """A profiled ``liver_mask_extent`` counts ``mask_box_voxels``: the
    voxels of the mask's nonzero box grown by one voxel, clipped to the
    volume, on the native core and on the scipy fallback."""
    from hdenseunet_tpu_torch import native

    if route == "scipy":
        monkeypatch.setattr(native, "pp_available", lambda: False)
    ext = np.zeros((20, 22, 24), np.uint8)
    if case == "inside":
        ext[5:12, 6:15, 7:19] = 1
        ext[8, 9, 10] = 2
    elif case == "on_faces":
        ext[0:4, 10:22, 20:24] = 2
    snap, _ = _spans(tmp_path, lambda: postprocess.liver_mask_extent(ext))
    want = {"inside": 9 * 11 * 14, "on_faces": 5 * 13 * 5, "empty": 0}[case]
    assert want == _grown_box_voxels(ext)
    assert snap["counts"] == {"mask_box_voxels": want}
    assert snap["spans"] == {}


def _spans(tmp_path, fn):
    """``fn()`` inside a CPU trace, from a cleared recorder; returns the
    recorder's snapshot and the trace's text."""
    TP.reset()
    with TP.trace(tmp_path, device="cpu"):
        fn()
    return TP.snapshot(), _trace_text(tmp_path)


def test_no_profiler_no_record(monkeypatch):
    """With no profiler open a span opens no profiler scope, reads no clock
    and records nothing; nor does a counter."""

    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler open")

    TP.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(TP, "time", types.SimpleNamespace(perf_counter=refuse))
    with TP.annotate("scoring", "1"), TP.annotate("window_batch"):
        TP.count("window_batches")
    assert TP.snapshot() == {"spans": {}, "counts": {}}


def test_nested_spans_count_total_and_self(tmp_path, monkeypatch):
    """outer [0, 10] holds inner [1, 3] and inner [4, 5]: self seconds are
    the total less what the children cover."""
    ticks = iter([0.0, 1.0, 3.0, 4.0, 5.0, 10.0])
    monkeypatch.setattr(TP, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))

    def nested():
        with TP.annotate("outer"):
            with TP.annotate("inner"):
                pass
            with TP.annotate("inner", "2"):
                pass

    snap, text = _spans(tmp_path, nested)
    assert snap["spans"] == {
        "outer": dict(count=1, total_s=10.0, self_s=7.0, syncs=0),
        "inner": dict(count=2, total_s=3.0, self_s=3.0, syncs=0),
    }
    assert '"outer"' in text and '"inner"' in text


def test_spans_in_two_threads_do_not_nest(tmp_path):
    """A span another thread opens and closes inside this thread's span is
    no child of it."""
    opened, closed = threading.Event(), threading.Event()

    def other():
        opened.wait(30)
        with TP.annotate("other"):
            pass
        closed.set()

    def mine():
        worker = threading.Thread(target=other)
        worker.start()
        with TP.annotate("mine"):
            opened.set()
            assert closed.wait(30)
        worker.join(30)
        assert not worker.is_alive()

    snap, _ = _spans(tmp_path, mine)
    assert snap["spans"]["mine"]["self_s"] == snap["spans"]["mine"]["total_s"] > 0
    assert snap["spans"]["other"]["count"] == 1


def test_count_and_reset(tmp_path):
    def counted():
        TP.count("stacks_2d", 20)
        TP.count("window_batches", 3)
        TP.count("window_batches")
        with TP.annotate("center"):
            pass

    snap, _ = _spans(tmp_path, counted)
    assert snap["counts"] == {"stacks_2d": 20, "window_batches": 4}
    assert snap["spans"]["center"]["count"] == 1
    TP.reset()
    assert TP.snapshot() == {"spans": {}, "counts": {}}


def test_syncs_go_to_the_innermost_span_unprinted(tmp_path):
    """c10's sync warning inside a span counts as a sync of the innermost
    span and is not shown; another warning is; an event wait counts once;
    the warning filters are restored when the last span closes."""
    waited = []

    class Event:
        def synchronize(self):
            waited.append(1)

    def synced():
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            filters, show = list(warnings.filters), warnings.showwarning
            with TP.annotate("scoring"):
                warnings.warn(TP.SYNC_WARNING)
                with TP.annotate("upload"):
                    warnings.warn(TP.SYNC_WARNING)
                    warnings.warn(TP.SYNC_WARNING)
                    warnings.warn("another warning")
                    TP.wait(Event())
            assert warnings.filters == filters and warnings.showwarning is show
            warnings.warn(TP.SYNC_WARNING)  # no span open: shown, not counted
        assert [str(w.message) for w in shown] == ["another warning", TP.SYNC_WARNING]

    snap, _ = _spans(tmp_path, synced)
    assert {k: v["syncs"] for k, v in snap["spans"].items()} == {"scoring": 1, "upload": 3}
    assert waited == [1]


def test_feed_queue_span(tmp_path):
    from hdenseunet_tpu_torch.data.pipeline import PrefetchIterator

    feed = PrefetchIterator(iter(range(3)), depth=2)
    snap, text = _spans(tmp_path, lambda: [next(feed) for _ in range(3)])
    feed.close()
    assert snap["spans"]["feed_queue"]["count"] == 3 and '"feed_queue"' in text


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


def test_train_step_and_multistep_spans(tmp_path):
    """One train_step and one MultiStep call of K = 2 on the CPU: put once
    a call, forward, backward and bn_merge once a step, optimizer twice
    (zero_grad, then the update); the CPU replays no graph. Training's
    counters are ``bn_live``, a K6 call: the tiny 2D network's 26 live BN
    sites and the 16 of them that remat reruns, a step; and ``dropout``, a
    K7 call: the decoder's one a step."""
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.train import trainer as T

    cfg = Config()
    cfg.model.preset, cfg.model.input_size = "tiny", 32
    cfg.train.arch, cfg.train.batch = "2d", 2
    state = T.create_train_state(cfg, "2d", device="cpu", seed=0)
    gen = synthetic_batches(mode="2d", batch=2, input_size=32, input_cols=8, seed=0)
    batches = [next(gen) for _ in range(3)]
    multi = T.make_multi_step(state, cfg, k=2)
    losses = []
    snap, text = _spans(tmp_path, lambda: losses.extend(
        [T.train_step(state, batches[0], cfg), multi(batches[1:])]))
    assert all(torch.isfinite(v).all() for v in losses)
    assert {name: s["count"] for name, s in snap["spans"].items()} == dict(
        put=2, forward=3, backward=3, optimizer=6, bn_merge=3)
    assert snap["counts"] == {"bn_live": 3 * (26 + 16), "dropout": 3}
    for scope in ("put", "forward", "backward", "optimizer", "bn_merge"):
        assert f'"{scope}"' in text, scope


def test_end2end_step_spans(tmp_path):
    """One tiny end2end train_step on the CPU: the hybrid's spans branch2d,
    branch3d, hff and loss once each, children of forward (its self time
    leaves them out); with no profiler open the step records nothing."""
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.train import trainer as T

    cfg = Config()
    cfg.model.preset, cfg.model.input_size = "tiny", 32
    cfg.train.arch, cfg.train.batch = "end2end", 1
    state = T.create_train_state(cfg, "end2end", device="cpu", seed=0)
    batch = next(synthetic_batches(mode="hybrid", batch=1, input_size=32, input_cols=8, seed=0))
    TP.reset()
    T.train_step(state, batch, cfg)
    assert TP.snapshot() == {"spans": {}, "counts": {}}
    snap, text = _spans(tmp_path, lambda: T.train_step(state, batch, cfg))
    inner = ("branch2d", "branch3d", "hff", "loss")
    assert {n: snap["spans"][n]["count"] for n in inner + ("forward",)} == dict.fromkeys(
        inner + ("forward",), 1)
    forward = snap["spans"]["forward"]
    children = sum(snap["spans"][n]["total_s"] for n in inner)
    assert forward["self_s"] == pytest.approx(forward["total_s"] - children, abs=1e-9)
    for scope in inner:
        assert f'"{scope}"' in text, scope
