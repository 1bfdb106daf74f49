"""The port's host-loop window predictor (``infer/sliding_window.py``,
``InferConfig.device_resident=False``) against the JAX package's on CPU:
window starts, probabilities, the segment's labelmap and the directory loop.

Tiny-preset weights come from the JAX ``hybrid.init`` and reach the port
through the parameter bridge, as in test_torch_infer.py, whose tolerance
and threshold rule this file shares.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.config import Config as JConfig, InferConfig as JInferConfig
from hdenseunet_tpu.infer import sliding_window as JS
from hdenseunet_tpu.infer.predictor import VolumePredictor as JVolumePredictor
from hdenseunet_tpu.models import hybrid as JH
from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.data import nifti
from hdenseunet_tpu_torch.infer import device_pipeline as TD, postprocess, sliding_window as TS
from hdenseunet_tpu_torch.infer.predictor import VolumePredictor, predict_directory
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from test_torch_infer import PROB_TOL, _ext_mask, _threshold_near, _volume

# (volume shape, window_batch): x and y multiples of 32, and not (edge
# padding to 64x64); 11 unique windows at the shipped batch of 8 (a short
# last batch of 3) and at 3 (of 2)
CASES = [((64, 64, 28), 8), ((48, 40, 28), 8), ((48, 40, 28), 3)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return JH.init(jax.random.key(0), input_size=32, input_cols=8, batch=1, preset="tiny")


def _port_model(tiny):
    return from_numpy(HDenseUNet(preset="tiny"), *tiny)


def _extent(shape):
    return postprocess.liver_mask_extent(_ext_mask(shape))[1:]


@pytest.fixture(scope="module")
def jax_probs(tiny):
    """JAX WindowPredictor's (liver, tumor) probabilities per case."""
    out = {}
    for shape, wb in CASES:
        vol = _volume(shape, seed=sum(shape))
        cfg = JInferConfig(window_batch=wb)
        out[shape, wb] = JS.WindowPredictor(*tiny, cfg, preset="tiny").predict_volume(vol, *_extent(shape))
    return out


@pytest.mark.parametrize("z", [8, 9, 28, 97])
def test_window_starts_is_the_originals_and_the_scorers(z):
    cfg = JInferConfig()
    assert TD.window_starts is TS.window_starts  # one copy, shared
    for lo in range(0, z, max(1, z // 6)):
        for hi in range(lo, z, max(1, z // 4)):
            assert TS.window_starts(z, lo, hi, cfg) == JS.window_starts(z, lo, hi, cfg)


@pytest.mark.parametrize("shape,wb", CASES)
def test_predict_volume_matches_jax(tiny, jax_probs, shape, wb):
    vol = _volume(shape, seed=sum(shape))
    lo, hi = _extent(shape)
    uniq = set(TS.window_starts(shape[2], lo, hi, InferConfig()))
    assert len(uniq) % wb  # the last batch is short and padded
    pred = TS.WindowPredictor(_port_model(tiny), InferConfig(window_batch=wb), device="cpu")
    got = pred.predict_volume(vol, lo, hi)
    for g, w in zip(got, jax_probs[shape, wb]):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_allclose(g, w, atol=PROB_TOL, rtol=0)
    assert got[0].max() > 0 and not got[0][:, :, : min(uniq) + 1].any()  # zero outside the scored z range


def test_edge_padding_repeats_the_last_row_and_column(tiny):
    """x and y pad to multiples of 32 with the edge values (mode='edge'),
    not zeros: a volume and its edge-padded self score the same windows."""
    vol = _volume((48, 40, 28), seed=3)
    lo, hi = _extent(vol.shape)
    pred = TS.WindowPredictor(_port_model(tiny), InferConfig(), device="cpu")
    small = pred.predict_volume(vol, lo, hi)
    padded = np.pad(vol, ((0, 16), (0, 24), (0, 0)), mode="edge")
    big = pred.predict_volume(padded, lo, hi)
    for s, b in zip(small, big):
        np.testing.assert_array_equal(s, b[:48, :40])


def _thresholds(liver, tumor):
    scored = liver > 0  # outside the scored z range every probability is 0
    return (_threshold_near(liver[scored], 0.6, PROB_TOL), _threshold_near(tumor[scored], 0.9, PROB_TOL))


def _configs(thresholds):
    knobs = dict(device_resident=False, thres_liver=thresholds[0], thres_tumor=thresholds[1])
    jcfg, pcfg = JConfig(), Config()
    for cfg in (jcfg, pcfg):
        cfg.model.preset = "tiny"
        cfg.infer = dataclasses.replace(cfg.infer, **knobs)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def segment_case(tiny, jax_probs):
    shape = (48, 40, 28)
    thresholds = _thresholds(*jax_probs[shape, 8])
    jcfg, pcfg = _configs(thresholds)
    vol = _volume(shape, seed=sum(shape)) + 48.0
    return vol, _ext_mask(shape), pcfg, JVolumePredictor(*tiny, jcfg).segment(vol, _ext_mask(shape))


@pytest.mark.parametrize("device_postprocess", [False, True])
def test_segment_byte_identical_to_jax(tiny, segment_case, device_postprocess):
    """The host loop's labelmap through compose_labelmap; the host loop
    postprocesses on the host whatever device_postprocess says, as JAX's
    does."""
    vol, ext, pcfg, want = segment_case
    pcfg = copy.deepcopy(pcfg)
    pcfg.infer = dataclasses.replace(pcfg.infer, device_postprocess=device_postprocess)
    vp = VolumePredictor(_port_model(tiny), pcfg, device="cpu")
    assert isinstance(vp.windows, TS.WindowPredictor)
    kind, *_ = handle = vp.dispatch(vol, ext)
    assert kind == "probs"
    got = vp.collect(handle)
    assert got.dtype == np.uint8 and got.shape == vol.shape
    assert (got == 1).any() and (got == 2).any()
    np.testing.assert_array_equal(got, want)


def test_predict_directory_segments_one_volume_at_a_time(tiny, segment_case, tmp_path):
    vol, ext, pcfg, want = segment_case
    data_dir, mask_dir, out_dir = tmp_path / "d", tmp_path / "m", tmp_path / "o"
    data_dir.mkdir(), mask_dir.mkdir()
    for i in range(2):
        nifti.write(data_dir / f"test-volume-{i}.nii", vol)
        nifti.write(mask_dir / f"test-volume-{i}-ori.nii", ext)
    logged = []
    times = predict_directory(
        _port_model(tiny), pcfg, data_dir=data_dir, liver_mask_dir=mask_dir,
        save_dir=out_dir, num_volumes=2, device="cpu", log=logged.append,
    )
    assert len(times) == 2 and all(t > 0 for t in times)
    assert logged[0].startswith("volume 0:") and logged[-1].startswith("mean")
    for i in range(2):
        got, _ = nifti.read(out_dir / f"test-segmentation-{i}.nii")
        np.testing.assert_array_equal(np.asarray(got), want)
