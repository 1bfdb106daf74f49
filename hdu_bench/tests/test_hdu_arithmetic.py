"""The harness's arithmetic on made-up inputs, and a cell, a configuration,
a traffic mix and a metric found as files."""
from __future__ import annotations

import json
import math
import shutil
import time

import pytest

from hdu_bench import harness
from hdu_bench import run as RUN
from hdu_bench.tests import tiny
from hdu_bench.work import counts


class _FakePredictor:
    """dispatch and collect that take known host time."""

    class windows:
        device = "cpu"

    def __init__(self, t_dispatch, t_collect):
        self.t_dispatch, self.t_collect, self.dispatched, self.collected = t_dispatch, t_collect, 0, 0

    def dispatch(self, vol, mask):
        time.sleep(self.t_dispatch)
        self.dispatched += 1
        return vol

    def collect(self, handle):
        time.sleep(self.t_collect)
        self.collected += 1
        return handle


def test_the_window_closes_on_whole_volumes():
    loop = RUN.load_module(RUN.HERE / "runners" / "serve.py", "serve_runner")._loop
    pred, spans = _FakePredictor(0.01, 0.03), harness.Spans()
    pool = [("a", None), ("b", None), ("c", None)]
    served, seconds = loop(pred, pool, spans, seconds=0.2)
    assert pred.dispatched == pred.collected == len(served) >= 5
    assert seconds >= 0.2  # the last volume started inside the window, and completed
    assert [i for i, _ in served] == [k % 3 for k in range(len(served))]
    rate = seconds / len(served)
    assert 0.04 <= rate <= 0.04 * 1.5  # one dispatch and one collect a volume
    assert spans.counts["dispatch"] == spans.counts["collect"] == len(served)


def _events():
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [
        x("user_annotation", "traced_window", 1000.0, 100.0),
        x("kernel", "k_a", 1010.0, 20.0), x("kernel", "k_b", 1020.0, 20.0),  # overlap
        x("kernel", "k_a", 1060.0, 10.0), x("gpu_memcpy", "Memcpy HtoD", 1090.0, 5.0),
        x("kernel", "k_late", 1098.0, 10.0),  # cut at the window's end
        x("user_annotation", "dispatch", 1000.0, 9.0),
        x("user_annotation", "collect", 1045.0, 13.0),
        x("user_annotation", "postprocess", 1052.0, 5.0),  # inside collect, not at the gap's middle
        x("cpu_op", "aten::add", 1080.0, 1.0),
    ]


def test_idle_share_from_a_timeline():
    t = harness.reduce_trace(_events())
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(47e-6)  # [10,40] + [60,70] + [90,95] + [98,100]
    assert t["device_ops"]["k_a"] == pytest.approx(30e-6)
    assert t["device_ops"]["k_late"] == pytest.approx(2e-6)
    idle = t["idle_by_scope"]
    assert idle["dispatch"] == pytest.approx(10e-6)  # [0, 10]
    assert idle["collect"] == pytest.approx(20e-6)  # [40, 60], middle 50
    assert idle["none"] == pytest.approx(23e-6)  # [70, 90], [95, 98]
    readers = RUN.metric_readers()
    run = {"metrics": {"serve_s_per_volume": 2.0}, "trace": t}
    assert readers["idle_pct.serve"].read(run) == pytest.approx(53.0)
    assert readers["idle_pct.graphed"].read(run) is None  # the cell reports no graphed steps


def test_roofline_share_and_mfu_from_known_counts():
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    m, k, n = 4096, 256, 128
    flops_s = 2.0 * m * n * k / peak["bf16_flops"]
    bytes_s = (m * k + n * k + m * n) * 2.0 / peak["hbm_bytes_per_s"]
    assert counts._bound([("x", m, k, n)], 1, peak) == pytest.approx(max(flops_s, bytes_s))
    assert counts._bound([("x", m, k, n)], 3, peak) == pytest.approx(
        max(3 * flops_s, (3 * m * k + n * k + 3 * m * n) * 2.0 / peak["hbm_bytes_per_s"]))
    readers = RUN.metric_readers()
    run = {"kind": "serve", "traced_units": 3,
           "work": {"k5_bound_s": 0.002, "flops": 1e15, "peaks": peak},
           "metrics": {"serve_s_per_volume": 2.0},
           "trace": {"device_ops": {"void affine_gemm_tma<...>": 0.012, "cudnn_conv": 1.0}}}
    assert readers["k5_roofline.serve"].read(run) == pytest.approx(50.0)
    assert readers["mfu.serve"].read(run) == pytest.approx(100.0 * 5e14 / 989.4e12)
    run["trace"]["device_ops"] = {"cudnn_conv": 1.0}
    assert readers["k5_roofline.serve"].read(run) is None  # nothing to read
    train = {"kind": "train", "work": {"flops": 3e12, "peaks": peak},
             "metrics": {"train_ms_per_step.eager": 100.0}, "spans": {"step_call": 2.0}, "count": 40}
    assert readers["mfu.eager"].read(train) == pytest.approx(100.0 * 3e13 / 989.4e12)
    assert readers["step_call_ms.eager"].read(train) == pytest.approx(50.0)
    assert readers["feed_wait_ms.eager"].read(train) is None  # no feed span
    assert readers["mfu.graphed"].read(train) is None
    assert readers["step_call_ms.graphed"].read(train) is None
    assert counts.peaks("NVIDIA A100-SXM4-80GB") is None


def test_a_cell_configuration_traffic_and_metric_added_as_files(tmp_path):
    root = tmp_path / "hdu_bench"
    shutil.copytree(RUN.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs" / "hdenseunet_copy.json").write_text(
        json.dumps(tiny.config("hdenseunet", "float32")))
    tr = tiny.traffic("closed1.z192.devpp", {"device_postprocess": False})
    tr["pool"] = 1
    (root / "traffic" / "tiny.one.json").write_text(json.dumps(tr))
    cell = {"config": "hdenseunet_copy", "traffic": "tiny.one", "chips": 1, "why": "added",
            "limits": RUN.load_json("workloads", "hdu.serve.devpp")["limits"]}
    (root / "workloads" / "added.cell.json").write_text(json.dumps(cell))
    (root / "metrics" / "volumes_seen.serve.py").write_text(
        'UNIT = "volumes"\n\ndef read(run):\n    return float(run["count"]) if "serve_s_per_volume" in run["metrics"] else None\n')
    found = RUN.load_json("workloads", "added.cell", root)
    cfg, traffic = RUN.load_json("configs", found["config"], root), RUN.load_json("traffic", found["traffic"], root)
    assert "volumes_seen.serve" in RUN.metric_readers(root)
    res = RUN.execute("added.cell", found, cfg, traffic, "cpu", seed=12, seconds=0.2, trace=1, root=root)
    assert res["correct"] and res["metrics"]["volumes_seen.serve"]["value"] >= 1
    assert not math.isnan(res["metrics"]["dispatch_s.serve"]["value"])
