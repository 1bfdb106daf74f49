"""The port's FLOP accounting against the JAX package's, and the H100 peaks.

``utils/flops.py`` counts conv FLOPs by running the real modules on the meta
device with the conv hook of ``models.layers.count_flops`` open; the JAX
package traces with ``jax.eval_shape``. The counts must be equal, per layer
name too, and ``DeviceVolumeScorer.estimate_flops`` must count exactly what
a scoring run executes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.config import InferConfig as JInferConfig
from hdenseunet_tpu.core.module import Ctx
from hdenseunet_tpu.infer.device_pipeline import DeviceVolumeScorer as JScorer
from hdenseunet_tpu.models import hybrid as JH
from hdenseunet_tpu.utils import flops as JF
from hdenseunet_tpu_torch.core.config import InferConfig
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
from hdenseunet_tpu_torch.models import denseunet2d as T2, denseunet3d as T3, layers as L
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from hdenseunet_tpu_torch.ops import fused_affine as K
from hdenseunet_tpu_torch.utils import flops as TF

REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize(
    "preset,x,cols,wb,n_stacks",
    [
        ("tiny", 32, 8, 1, 8),
        ("tiny", 64, 8, 4, 18),
        ("tiny", 96, 4, 2, 0),
        ("full", 224, 8, 1, 8),
        ("full", 512, 8, 8, 36),  # the serve shape: one dedup run of 8 windows
    ],
)
def test_hybrid_window_batch_flops_match_jax(preset, x, cols, wb, n_stacks):
    kw = dict(x=x, y=x, cols=cols, wb=wb, n_stacks_2d=n_stacks, preset=preset)
    got, want = TF.hybrid_window_batch_flops(**kw), JF.hybrid_window_batch_flops(**kw)
    assert got > 0 and abs(got - want) <= REL * want, (got, want)


@pytest.mark.parametrize("which", ["2d", "3d"])
@pytest.mark.parametrize("preset", ["tiny", "full"])
def test_conv_flops_of_each_branch_match_jax(which, preset):
    from hdenseunet_tpu.models import denseunet2d as J2, denseunet3d as J3

    if which == "2d":
        net = T2.DenseUNet2D(device="meta", **T2.PRESETS[preset])
        got = TF.conv_flops(net, (2, 64, 96, 3), bn_frozen=True, decoder_dropout=0.0)
        want = JF.conv_flops(J2.apply, (2, 64, 96, 3), bn_frozen=True, decoder_dropout=0.0,
                             **J2.PRESETS[preset])
    else:
        net = T3.DenseUNet3D(device="meta", **T3.PRESETS[preset])
        got = TF.conv_flops(net, (1, 64, 32, 12, 4))
        want = JF.conv_flops(J3.apply, (1, 64, 32, 12, 4), **J3.PRESETS[preset])
    assert got > 0 and abs(got - want) <= REL * want, (got, want)


def test_flop_table_matches_jax_per_layer():
    """The per-layer-name table of one tiny hybrid forward equals the JAX
    hook's ``flop_table`` name for name, and sums to the total."""
    ctx = Ctx(record=True, train=False)
    ctx.flops, ctx.flop_table = [0.0], {}
    jax.eval_shape(lambda v: JH.apply(ctx, v, preset="tiny"),
                   jax.ShapeDtypeStruct((2, 64, 32, 8, 1), np.float32))
    table: dict = {}
    model = HDenseUNet(preset="tiny", device="meta")
    with torch.no_grad(), L.count_flops(table) as counter:
        model(torch.empty((2, 64, 32, 8, 1), device="meta"))
    assert table.keys() == ctx.flop_table.keys()
    for name, f in table.items():
        assert f == ctx.flop_table[name], name
    assert counter.total == pytest.approx(ctx.flops[0], rel=REL)
    assert sum(table.values()) == pytest.approx(counter.total, rel=REL)


@pytest.mark.parametrize(
    "size,kernel,stride,padding",
    [
        ((9, 10), 3, 1, "same"),
        ((9, 10), 3, 2, "same"),  # uneven TF split: the F.pad route
        ((8, 8), 7, 2, 3),
        ((7, 9), 1, 1, "valid"),
        ((6, 7, 5), 3, (2, 2, 1), "same"),
    ],
)
def test_counted_output_size_is_the_convs_own(size, kernel, stride, padding):
    """The hook's output extent is the one the forward produces, on both
    the symmetric-padding and the F.pad route."""
    nd = len(size)
    conv = L.Conv(5, 6, kernel, ndim=nd, stride=stride, padding=padding, name="c")
    init_model(torch.nn.ModuleDict({"c": conv}), 0)
    table: dict = {}
    with torch.no_grad(), L.count_flops(table):
        y = conv(torch.randn((2, 5) + size))
    k = L.norm_tuple(kernel, nd)
    want = 2.0 * 2 * np.prod(y.shape[2:]) * 6 * np.prod(k) * 5
    assert table == {"c": want}


def test_counter_closes_and_nests():
    conv = L.Conv(3, 4, 3, ndim=2, name="c", device="meta")
    x = torch.empty((1, 3, 8, 8), device="meta")
    with L.count_flops() as outer:
        conv(x)
        with L.count_flops() as inner:
            conv(x)
        conv(x)
    conv(x)  # closed: counts nowhere
    assert inner.total > 0 and outer.total == 2 * inner.total


def test_meta_tensors_take_k1s_plain_version():
    x = torch.empty((2, 8, 4, 4), device="meta").contiguous(memory_format=torch.channels_last)
    a = torch.empty((8,), device="meta")
    before = K.affine_relu.launches
    y = K.affine_relu(x, a, a)
    assert y.is_meta and y.shape == x.shape and K.affine_relu.launches == before


def _scorers(preset, knobs):
    cfg = dataclasses.replace(InferConfig(), **knobs)
    jcfg = dataclasses.replace(JInferConfig(), **knobs)
    port = DeviceVolumeScorer(HDenseUNet(preset=preset, device="meta"), cfg, device="meta")
    return port, JScorer(None, None, jcfg, preset=preset)


MODES = {"dedup-2D": {}, "per-window": dict(dedup_2d=False), "shared-2D": dict(shared_2d=True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "preset,shape,liver",
    [
        ("tiny", (64, 64, 28), (4, 20)),
        ("tiny", (96, 64, 140), (10, 120)),
        ("tiny", (40, 72, 40), (0, 39)),  # xy padded to multiples of 32
        ("full", (512, 512, 96), (19, 76)),  # the serve volume
    ],
)
def test_estimate_flops_matches_jax(mode, preset, shape, liver):
    """The port counts the batches it runs: every batch of the plan with a
    nonzero weight. The JAX program also runs the plan's all-zero padding
    batches, so its count is the port's plus one batch body for each."""
    port, jax_scorer = _scorers(preset, MODES[mode])
    p, jp = port.plan(shape, *liver), jax_scorer.plan(shape, *liver)
    np.testing.assert_array_equal(p["starts"], jp["starts"])
    np.testing.assert_array_equal(p["weights"], jp["weights"])
    idle = int((~p["weights"].any(axis=1)).sum())
    if MODES[mode].get("shared_2d"):
        body = JF.hybrid_window_batch_flops(x=p["xp"], y=p["yp"], cols=8, wb=p["wb"], n_stacks_2d=0,
                                            preset=preset)
    else:
        body = jax_scorer.estimate_flops(shape, *liver) / len(jp["starts"])
    got, want = port.estimate_flops(shape, *liver), jax_scorer.estimate_flops(shape, *liver)
    assert got > 0 and abs(got + idle * body - want) <= REL * want, (got, idle, body, want)


def test_estimate_flops_equals_jax_without_padding_batches():
    """A liver range whose plan has no all-zero batch: the counts are equal."""
    port, jax_scorer = _scorers("tiny", {})
    shape, liver = (64, 64, 60), (10, 50)
    assert port.plan(shape, *liver)["weights"].any(axis=1).all()
    got, want = port.estimate_flops(shape, *liver), jax_scorer.estimate_flops(shape, *liver)
    assert abs(got - want) <= REL * want


@pytest.mark.parametrize("mode", list(MODES))
def test_executed_count_equals_estimate(mode):
    """A tiny scoring run on the CPU with the counter open counts exactly
    estimate_flops, on a plan with all-zero padding batches."""
    cfg = dataclasses.replace(InferConfig(), **MODES[mode])
    scorer = DeviceVolumeScorer(init_model(HDenseUNet(preset="tiny"), 0), cfg, device="cpu")
    vol = np.random.default_rng(0).normal(0, 50, (64, 64, 28)).astype(np.float32)
    assert not scorer.plan(vol.shape, 4, 20)["weights"].any(axis=1).all()
    with L.count_flops() as counter:
        scorer.score(vol, 4, 20)
    assert counter.total == scorer.estimate_flops(vol.shape, 4, 20)


@pytest.mark.parametrize(
    "kind,tflops",
    [
        ("NVIDIA H100 80GB HBM3", 989.4),
        ("NVIDIA H100 SXM5 80GB", 989.4),
        ("NVIDIA H100 PCIe", 756.0),
    ],
)
def test_peak_of_h100s(kind, tflops, monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert TF.peak_flops_per_chip(kind) == tflops * 1e12


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite", "NVIDIA H100 NVL"])
def test_unknown_card_raises(kind, monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    with pytest.raises(ValueError, match="BENCH_PEAK_TFLOPS"):
        TF.peak_flops_per_chip(kind)


def test_peak_override(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert TF.peak_flops_per_chip("TPU v5 lite") == 123.5e12
    assert TF.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 123.5e12
