"""bench_torch.py, the port's headline harness, against bench.py's
definitions: the copied slope protocol, the harness end to end on the CPU
at the tiny preset, its inputs and plan against the JAX scorer's, the FLOP
counts with their one known difference, and how it refuses and fails.
"""
import ast
import inspect
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (its top level imports no JAX)
import bench_torch  # noqa: E402
from hdenseunet_tpu.core.config import InferConfig as JInferConfig  # noqa: E402
from hdenseunet_tpu.infer import postprocess as j_post  # noqa: E402
from hdenseunet_tpu.infer.device_pipeline import DeviceVolumeScorer as JScorer  # noqa: E402
from hdenseunet_tpu.models import denseunet2d as J2  # noqa: E402
from hdenseunet_tpu.utils import flops as JF  # noqa: E402
from hdenseunet_tpu_torch.core.config import InferConfig  # noqa: E402
from hdenseunet_tpu_torch.infer import postprocess as t_post  # noqa: E402
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer  # noqa: E402
from hdenseunet_tpu_torch.models import denseunet2d as T2  # noqa: E402
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet  # noqa: E402
from hdenseunet_tpu_torch.utils import flops as TF  # noqa: E402

# The CPU smoke of the harness (README): every phase, one rep each
SMOKE_ENV = dict(
    BENCH_CPU="1", BENCH_PRESET="tiny", BENCH_Z="32", BENCH_REPS="1", BENCH_COMPUTE_REPS="1",
    BENCH_TRAIN_STEPS="2", BENCH_TRAIN_REPS="1", BENCH_TRAIN_SLOPE_REPS="1",
    BENCH_TRAIN_K_SMALL="1", BENCH_TRAIN_K_BIG="2", BENCH_PIPELINE_VOLUMES="1",
)
# The keys bench.py:450-462 prints, phase by phase, as its phases set them
# (bench.py:231-250, :371-380, :411-425, :284-288); where bench.py prints
# one of two sets, both are listed
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline", "model_tflops", "achieved_tflops", "mfu"]
COMPUTE_KEYS = ["compute_spread", "compute_t_small_s", "compute_t_big_s", "compute_k_big"]
COMPUTE_RELIABLE = ["compute_s_per_volume", "compute_mfu"]
COMPUTE_UNRELIABLE = ["compute_unreliable"]
ATTRIB_KEYS = ["dispatch_s", "h2d_s", "wire_mb"]
ATTRIB_WITH_COMPUTE = ["decomp_gap_s"]
PIPELINE_KEYS = ["pipelined_s_per_volume", "pipelined_volumes", "pipelined_vs_baseline"]
TRAIN_KEYS = ["train_ms_per_step", "train_slices_per_s_chip", "train_mfu", "train_compute_spread"]
TRAIN_RELIABLE = ["train_compute_ms_per_step", "train_compute_slices_per_s_chip", "train_compute_mfu"]
TRAIN_UNRELIABLE = ["train_compute_unreliable", "train_compute_t_small_s", "train_compute_t_big_s"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _timer(values, calls=None, name=None):
    it = iter(values)

    def timed():
        if calls is not None:
            calls[name] += 1
        return next(it)

    return timed


@pytest.mark.parametrize("small,big,k_small,k_big,reps", [
    # tests/test_bench_protocol.py's sequences: a clean slope from minima,
    # a first round recovered by the retry, both rounds inverted
    ([2.5, 2.0, 9.0, 2.2], [10.5, 18.0, 10.0, 11.0], 1, 5, 4),
    ([12.0, 11.5, 2.0, 2.1], [10.0, 10.2, 10.1, 10.3], 1, 5, 2),
    ([10.0] * 4, [5.0] * 4, 1, 5, 2),
    # both rounds non-monotone, the retry's minima no better; then equal
    # minima (slope 0), and bench.py's train endpoints
    ([6.0, 7.0, 5.5, 6.5], [5.0, 6.0, 5.4, 5.2], 1, 5, 2),
    ([3.0, 3.1, 3.0, 3.2], [3.0, 3.3, 3.4, 3.0], 1, 5, 2),
    ([0.5, 0.4, 0.45], [4.5, 4.4, 4.6], 4, 64, 3),
])
def test_hardened_slope_equals_bench_py(small, big, k_small, k_big, reps):
    """Every output key, and the calls each endpoint took, equal bench.py's."""
    results = []
    for fn in (bench_torch.hardened_slope, bench.hardened_slope):
        calls = {"small": 0, "big": 0}
        out = fn(_timer(small, calls, "small"), _timer(big, calls, "big"), k_small, k_big, reps)
        results.append((out, calls))
    (got, got_calls), (want, want_calls) = results
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key] and type(got[key]) is type(want[key]), key
    assert got_calls == want_calls


@pytest.mark.parametrize("name", ["hardened_slope", "_note"])
def test_copied_functions_are_bench_py_verbatim(name):
    """The copies' statements, their docstrings aside."""
    def code(module):
        fn = ast.parse(inspect.getsource(getattr(module, name))).body[0]
        if isinstance(fn.body[0], ast.Expr) and isinstance(fn.body[0].value, ast.Constant):
            fn.body = fn.body[1:]
        return ast.dump(fn)

    assert code(bench_torch) == code(bench)
    assert bench_torch.BASELINE_SEC_PER_VOLUME == bench.BASELINE_SEC_PER_VOLUME == 100.0


def _smoke(monkeypatch, capsys, **env):
    for key in ("BENCH_UNROLL", "BENCH_SHARED2D"):
        monkeypatch.delenv(key, raising=False)
    for key, value in {**SMOKE_ENV, **env}.items():
        monkeypatch.setenv(key, value)
    status = bench_torch.main()
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    return status, lines


def test_harness_end_to_end_on_the_cpu(monkeypatch, capsys):
    """The tiny CPU smoke: one cumulative line per phase, each keeping every
    key of the one before; the last has every key bench.py prints for these
    phases, finite numbers, the CPU named as its card, and no error."""
    status, lines = _smoke(monkeypatch, capsys)
    assert status == 0
    assert len(lines) == 5  # headline, compute slope, attribution, pipelined, train
    for before, after in zip(lines, lines[1:]):
        assert before.items() <= after.items()
    last = lines[-1]
    want = HEADLINE_KEYS + COMPUTE_KEYS + ATTRIB_KEYS + PIPELINE_KEYS + TRAIN_KEYS
    assert not [k for k in want if k not in last]
    reliable = [k in last for k in COMPUTE_RELIABLE + ATTRIB_WITH_COMPUTE]
    assert all(reliable) != all(k in last for k in COMPUTE_UNRELIABLE), last
    assert any(reliable) == all(reliable)
    trained = [k in last for k in TRAIN_RELIABLE]
    assert all(trained) != all(k in last for k in TRAIN_UNRELIABLE), last
    assert any(trained) == all(trained)
    assert not [k for k in last if k.endswith("_error")]
    assert (last["metric"], last["unit"], last["card"], last["power_limit_w"]) == (
        "hybrid_inference_volume_latency", "s/volume", "cpu", None)
    assert last["compute_k_big"] == 5 and last["pipelined_volumes"] == 1
    numbers = {k: v for k, v in last.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
    assert all(math.isfinite(v) for v in numbers.values()), numbers
    # the wire: 64x64 by the plan's zw (32 slices) bf16; the plan's FLOPs
    assert last["wire_mb"] == round(64 * 64 * 32 * 2 / 1e6, 1)
    assert last["model_tflops"] == round(89981749248.0 / 1e12, 2)


def test_a_failed_phase_is_flagged_and_exits_1(monkeypatch, capsys):
    def broken(preset, device):
        raise RuntimeError("broken train phase")

    monkeypatch.setattr(bench_torch, "measure_train", broken)
    status, lines = _smoke(monkeypatch, capsys, BENCH_COMPUTE="0", BENCH_PIPELINE="0")
    assert status == 1
    assert len(lines) == 3  # headline, attribution, train
    assert lines[-1]["train_error"] is True and "train_ms_per_step" not in lines[-1]
    assert "decomp_gap_s" not in lines[-1]  # no compute slope: no gap


def _plan_keys(p):
    return {k: v for k, v in p.items() if k not in ("starts", "weights", "zw")}


@pytest.mark.parametrize("preset,size,z", [("tiny", 64, 32), ("full", 512, 192)])
def test_inputs_and_plan_equal_bench_py_and_the_jax_scorer(preset, size, z):
    """bench.py's volume, liver z-range and pipelined mask (its expressions,
    bench.py:339-341 and :267-268), and the JAX scorer's plan of that
    volume, at the tiny smoke's size and at the defaults."""
    vol, mini_z, maxi_z = bench_torch.volume_case(size, z)
    want = np.random.default_rng(0).normal(0.0, 60.0, (size, size, z)).astype(np.float32)
    assert vol.dtype == np.float32 and np.array_equal(vol, want)
    assert (mini_z, maxi_z) == (int(z * 0.2), int(z * 0.8))
    mask = np.zeros(vol.shape, np.uint8)
    mask[64:-64, 64:-64, mini_z:maxi_z] = 1
    got_mask = bench_torch.pipeline_mask(vol.shape, mini_z, maxi_z)
    assert got_mask.dtype == np.uint8 and np.array_equal(got_mask, mask)
    got_ext, want_ext = t_post.liver_mask_extent(got_mask), j_post.liver_mask_extent(mask)
    assert got_ext[1:] == want_ext[1:] and np.array_equal(got_ext[0], np.asarray(want_ext[0]))

    jsc = JScorer(None, None, JInferConfig(input_size=size, window_batch=8), arch="end2end",
                  preset=preset, compute_dtype="bfloat16", z_bucket=64)
    tsc = DeviceVolumeScorer(HDenseUNet(preset=preset, device="meta"), InferConfig(input_size=size),
                             arch="end2end", compute_dtype="bfloat16", device="meta")
    for lo, hi in ((mini_z, maxi_z), got_ext[1:]):  # the headline's range, the pipelined one
        jp, tp = jsc.plan(vol.shape, lo, hi), tsc.plan(vol.shape, lo, hi)
        assert _plan_keys(tp) == _plan_keys(jp)
        assert np.array_equal(tp["starts"], jp["starts"]) and np.array_equal(tp["weights"], jp["weights"])
        assert tp["zw"] == min(jp["zp"], -(-jp["z"] // jsc._WIRE_BUCKET) * jsc._WIRE_BUCKET)


@pytest.mark.parametrize("preset,size,z,batches,live,port_flops", [
    # tiny: 4 batches, the last all padding (JAX 119.98 GFLOP, port 89.98)
    ("tiny", 64, 32, 4, 3, 89981749248.0),
    # the defaults (512x512x192): 8 batches, all live, so the counts agree
    ("full", 512, 192, 8, 8, 161277112483840.0),
])
def test_estimate_flops_is_jax_less_its_padding_batches(preset, size, z, batches, live, port_flops):
    vol, mini_z, maxi_z = bench_torch.volume_case(size, z)
    jsc = JScorer(None, None, JInferConfig(input_size=size, window_batch=8), arch="end2end",
                  preset=preset, compute_dtype="bfloat16", z_bucket=64)
    tsc = DeviceVolumeScorer(HDenseUNet(preset=preset, device="meta"), InferConfig(input_size=size),
                             arch="end2end", compute_dtype="bfloat16", device="meta")
    weights = tsc.plan(vol.shape, mini_z, maxi_z)["weights"]
    assert (len(weights), int(weights.any(axis=1).sum())) == (batches, live)
    got, want = tsc.estimate_flops(vol.shape, mini_z, maxi_z), jsc.estimate_flops(vol.shape, mini_z, maxi_z)
    assert got == port_flops
    assert got == want * live / batches  # every batch counts the same


def test_train_mfu_counts_the_jax_forward():
    """measure_train's FLOPs: the 2D forward at batch 8, train-mode BN, no
    dropout, as bench.py:225-228 counts it."""
    net = T2.DenseUNet2D(num_classes=3, device="meta", **T2.PRESETS["tiny"])
    got = TF.conv_flops(net, (8, 64, 64, 3), bn_frozen=False, decoder_dropout=0.0)
    want = JF.conv_flops(J2.apply, (8, 64, 64, 3), bn_frozen=False, decoder_dropout=0.0,
                         **J2.PRESETS["tiny"])
    assert got == want == 539191296.0


def test_bench_unroll_stops_the_harness(monkeypatch):
    monkeypatch.setenv("BENCH_UNROLL", "2")
    with pytest.raises(SystemExit, match="BENCH_UNROLL has no counterpart"):
        bench_torch.main()


def test_without_a_card_or_bench_cpu_it_raises():
    """No card and no BENCH_CPU: a message and a non-zero exit, no line."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is false" in out.stderr
