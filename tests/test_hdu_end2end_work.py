"""The work counts of the end-to-end stage's step
(``hdu_bench/work/train_hybrid.py``) and the reader of K1's roofline in it
(``hdu_bench/metrics/k1_roofline.end2end.py``) on made-up runs."""
from __future__ import annotations

import pytest
import torch

from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet, stack_adjacent_slices
from hdu_bench import run as RUN
from hdu_bench.tests import tiny
from hdu_bench.work import counts
from hdu_bench.work import train_hybrid as W

H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.fixture
def reader():
    return RUN.metric_readers()["k1_roofline.end2end"]


def _run(**changes):
    run = {
        "metrics": {"train_ms_per_step.graphed": 170.0},
        "trace": {"busy_s": 1.0, "window_s": 1.1, "device_ops": {
            "void affine_relu_vec<__nv_bfloat16>(__nv_bfloat16 const*, float const*)": 0.006,
            "void affine_relu_bwd<__nv_bfloat16>(__nv_bfloat16 const*, int)": 0.010,
            "affine_gemm_tma(CUtensorMap, CUtensorMap)": 1.0,
            "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": 2.0,
        }},
        "traced_units": 2,
        "work": {"flops": 1.0, "k1_bound_s": 0.004},
    }
    run.update(changes)
    return run


def test_k1_roofline_reads_k1_and_not_k5(reader):
    """K1's forward and backward, 0.016 s over 2 steps, against a bound of
    0.004 s a step: 50 %; K5's and cuDNN's kernels are not K1's."""
    assert reader.read(_run()) == pytest.approx(50.0)


@pytest.mark.parametrize("case", ["no_bound", "no_trace", "no_moves", "no_k1"])
def test_k1_roofline_finds_nothing(reader, case):
    """None for a run without the bound (the 2D stage's), without a trace,
    reporting another end-to-end metric, or where no K1 kernel ran."""
    run = _run()
    if case == "no_bound":
        run["work"] = {"flops": 1.0}
    elif case == "no_trace":
        del run["trace"]
    elif case == "no_moves":
        run["metrics"] = {"serve_s_per_volume": 1.0}
    else:
        run["trace"]["device_ops"] = {"affine_gemm_tma(CUtensorMap)": 1.0}
    assert reader.read(run) is None


def test_step_flops_are_the_2d_slices_and_the_windows():
    cfg = RUN.load_json("configs", "hdenseunet_end2end")
    f2d = counts.forward_2d(cfg, 64, 224, prefix="net2d.").flops
    f3d = counts.window_3d(cfg, 224, 224).flops
    assert W.train_step(cfg, 8, 224) == pytest.approx(3.0 * (f2d + 8 * f3d), rel=1e-12)
    assert 0.0 < f3d < f2d


def test_k1_bound_of_the_published_step():
    """161 frozen BN-Scale-ReLUs a slice, 10 bytes an element over the HBM
    rate; no bound without the card's peaks."""
    cfg = RUN.load_json("configs", "hdenseunet_end2end")
    n = W.k1_elements(cfg, 64, 224)
    assert n == 64 * W.k1_elements(cfg, 1, 224)
    assert W.k1_bound_s(cfg, 64, 224, H100) == pytest.approx(10 * n / 3.35e12)
    assert W.k1_bound_s(cfg, 64, 224, None) is None


def test_k1_elements_are_the_programs_frozen_bn_scale_relus(monkeypatch):
    """At the tiny cut, the elements the count traverses equal the outputs
    of every K1 call in the port's 2D branch of one training forward."""
    cfg = tiny.config("hdenseunet_end2end", "float32")
    b, s, d = 2, 64, cfg["infer"]["input_cols"]
    seen = []
    inner = L.AffineReLU

    class Spy:
        @staticmethod
        def apply(*args):
            y = inner.apply(*args)
            seen.append(y.numel())
            return y

    monkeypatch.setattr(L, "AffineReLU", Spy)
    model = HDenseUNet(preset="tiny", device="cpu")
    for t in model.state_dict().values():
        torch.nn.init.uniform_(t, 0.5, 1.0)
    vol = torch.randn((b, s, s, d, 1))
    ctx = L.Ctx(0, device="cpu")
    model.net2d(stack_adjacent_slices(vol), ctx, bn_frozen=True, decoder_dropout=0.0)
    assert len(seen) == 1 + 2 * sum(cfg["net2d"]["blocks"]) + len(cfg["net2d"]["blocks"])
    assert sum(seen) == W.k1_elements(cfg, b * d, s)
