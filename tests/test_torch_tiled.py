"""The port's x/y/z-tiled scorer (``TiledVolumeScorer``, ``TiledPredictor``,
``test --tiled``) against the JAX package's on CPU: tile origins,
probabilities (a volume smaller than the tile in x and y included), the
segment's labelmap and the CLI route.

Tiny-preset weights come from the JAX ``hybrid.init`` through the parameter
bridge, as in test_torch_infer.py, whose tolerance and threshold rule this
file shares.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.config import Config as JConfig, InferConfig as JInferConfig
from hdenseunet_tpu.infer import device_pipeline as JD
from hdenseunet_tpu.infer.predictor import TiledPredictor as JTiledPredictor
from hdenseunet_tpu.models import hybrid as JH
from hdenseunet_tpu_torch import cli
from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.data import nifti
from hdenseunet_tpu_torch.infer import device_pipeline as TD
from hdenseunet_tpu_torch.infer.predictor import TiledPredictor
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from hdenseunet_tpu_torch.train import trainer
from test_torch_infer import PROB_TOL, _ext_mask, _threshold_near, _volume

WB = 4
# (volume shape, tile): 3x3x3 windows of 32x32x8 over 64x64x20; one
# 64x64x8 window per z origin over a 40x48x12 volume zero-padded to 64x64
CASES = [((64, 64, 20), 32), ((40, 48, 12), 64)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return JH.init(jax.random.key(0), input_size=32, input_cols=8, batch=1, preset="tiny")


def _port_scorer(tiny, tile):
    model = from_numpy(HDenseUNet(preset="tiny"), *tiny)
    return TD.TiledVolumeScorer(model, InferConfig(window_batch=WB), tile=tile, device="cpu")


@pytest.fixture(scope="module")
def jax_scores(tiny):
    out = {}
    for shape, tile in CASES:
        scorer = JD.TiledVolumeScorer(*tiny, JInferConfig(window_batch=WB), tile=tile, preset="tiny")
        out[shape] = np.asarray(scorer.score(_volume(shape, seed=sum(shape))))
    return out


def test_tile_origins_equal_the_originals():
    for dim in range(1, 70, 3):
        for win in range(1, dim + 1, 4):
            for step in (1, 2, (win // 3) * 2 or 1, win, win + 3):
                assert TD.tile_origins(dim, win, step) == JD.tile_origins(dim, win, step), (dim, win, step)


@pytest.mark.parametrize("shape,tile", CASES)
def test_plan_counts_windows_and_batches(tiny, shape, tile):
    scorer = _port_scorer(tiny, tile)
    p = scorer.plan(shape)
    padded = tuple(max(d, w) for d, w in zip(shape, (tile, tile, 8)))
    assert p["padded"] == padded and p["win"] == (tile, tile, 8) and p["wb"] == WB
    steps = ((tile // 3) * 2, (tile // 3) * 2, 4)
    axes = [JD.tile_origins(d, w, s) for d, w, s in zip(padded, p["win"], steps)]
    assert p["origins"] == [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


@pytest.mark.parametrize("shape,tile", CASES)
def test_tiled_scorer_matches_jax(tiny, jax_scores, shape, tile):
    scorer = _port_scorer(tiny, tile)
    vol = _volume(shape, seed=sum(shape))
    got = scorer.score(vol)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (3,)
    np.testing.assert_allclose(got.numpy(), jax_scores[shape], atol=PROB_TOL, rtol=0)
    score, count = scorer._score_tiles(vol, scorer.plan(shape))
    assert bool((count > 0).all()) and float(count.max()) > 1  # every voxel, some twice
    # the average divides by max(count, 1e-4), not count + 1e-4: exact
    # where one window covers a voxel
    once = count[: shape[0], : shape[1], : shape[2]] == 1
    assert torch.equal(got[once], score[: shape[0], : shape[1], : shape[2]][once])
    lp, tp = scorer.predict_volume(vol)
    np.testing.assert_array_equal(lp, got[..., 1].numpy())
    np.testing.assert_array_equal(tp, got[..., 2].numpy())


def test_tile_must_divide_by_32(tiny):
    with pytest.raises(ValueError, match="divisible by 32"):
        _port_scorer(tiny, 48)


def _configs(thresholds):
    jcfg, pcfg = JConfig(), Config()
    for cfg in (jcfg, pcfg):
        cfg.model.preset = "tiny"
        cfg.infer = dataclasses.replace(
            cfg.infer, window_batch=WB, thres_liver=thresholds[0], thres_tumor=thresholds[1]
        )
    return jcfg, pcfg


@pytest.mark.parametrize("shape,tile", CASES)
def test_tiled_predictor_segment_byte_identical_to_jax(tiny, jax_scores, shape, tile):
    probs = jax_scores[shape]
    thresholds = (_threshold_near(probs[..., 1], 0.6, PROB_TOL), _threshold_near(probs[..., 2], 0.9, PROB_TOL))
    jcfg, pcfg = _configs(thresholds)
    vol = _volume(shape, seed=sum(shape)) + 48.0
    ext = _ext_mask(shape)
    want = JTiledPredictor(*tiny, jcfg, tile=tile).segment(vol, ext)
    got = TiledPredictor(from_numpy(HDenseUNet(preset="tiny"), *tiny), pcfg, tile=tile, device="cpu").segment(vol, ext)
    assert got.dtype == np.uint8 and got.shape == shape
    assert (got == 1).any() and (got == 2).any()
    np.testing.assert_array_equal(got, want)


def test_cli_test_tiled_on_the_cpu(tmp_path, capsys):
    """``test --tiled`` writes the labelmap TiledPredictor gives for the
    same seeded weights, one volume at a time."""
    shape = (40, 48, 12)
    vol = _volume(shape, seed=1) + 48.0
    ext = _ext_mask(shape)
    for d in ("tv", "tm"):
        (tmp_path / d).mkdir()
    nifti.write(tmp_path / "tv" / "test-volume-0.nii", vol)
    nifti.write(tmp_path / "tm" / "0-ori.nii", ext)
    args = ["--set", "model.preset", "tiny", "--set", "infer.window_batch", str(WB)]
    times = cli.main(["test", "--data", str(tmp_path / "tv"), "--livermask", str(tmp_path / "tm"),
                      "--save-path", str(tmp_path / "res"), "--num-volumes", "1", "--tiled", "64",
                      "--device", "cpu", *args])
    assert len(times) == 1 and "volume 0: (40, 48, 12) segmented" in capsys.readouterr().out
    got, _ = nifti.read(tmp_path / "res" / "test-segmentation-0.nii")
    cfg = cli._load_config(None, dict(zip(args[1::3], args[2::3])))
    cfg.train.arch = "end2end"
    model = trainer.create_train_state(cfg, "end2end", device="cpu").model
    want = TiledPredictor(model, cfg, tile=64, device="cpu").segment(vol, ext)
    assert np.asarray(got).shape == shape
    np.testing.assert_array_equal(np.asarray(got), want)
