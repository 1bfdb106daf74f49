"""The scorers in each form of the 3D branch that ``InferConfig`` reaches
(``layout3d`` 'hwdc' | 'dhwc' x ``stem_s2d``) against the JAX package's
scorers with the same config, on CPU in float32: the dedup-2D, per-window,
shared-2D and tiled routes. Probabilities within test_torch_infer.py's
PROB_TOL, labelmaps byte for byte at thresholds taken from JAX's own
probabilities with none of them within PROB_TOL (its threshold rule).

Tiny-preset weights come from the port's seeded initializer and reach the
JAX scorers as its pytree.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.config import InferConfig as JInferConfig
from hdenseunet_tpu.infer import device_pipeline as JD
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.config import InferConfig
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.infer import device_pipeline as TD
from hdenseunet_tpu_torch.infer import postprocess
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from test_torch_infer import PROB_TOL, _ext_mask, _near_threshold, _thresholds, _volume

SHAPE = (48, 40, 28)  # x and y padded to 64 and 64 for the compute
ROUTES = {  # route: InferConfig fields
    "dedup": {},
    "per_window": dict(dedup_2d=False),
    "shared_2d": dict(shared_2d=True),
    "tiled": dict(window_batch=4),
}
FORMS = [("hwdc", False), ("hwdc", True), ("dhwc", False), ("dhwc", True)]
TILE = 32


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    model = init_model(HDenseUNet(preset="tiny"), 0)
    return model.state_dict(), P.to_numpy(model)


def _port_model(tiny):
    model = HDenseUNet(preset="tiny")
    model.load_state_dict(tiny[0])
    return model


def _scorers(tiny, route, layout3d, stem_s2d, thresholds=None):
    """(JAX scorer, port scorer) of the route in the form."""
    knobs = dict(ROUTES[route], layout3d=layout3d, stem_s2d=stem_s2d)
    if thresholds is not None:
        knobs.update(thres_liver=thresholds[0], thres_tumor=thresholds[1])
    jcfg = dataclasses.replace(JInferConfig(), **knobs)
    pcfg = dataclasses.replace(InferConfig(), **knobs)
    if route == "tiled":
        return (JD.TiledVolumeScorer(*tiny[1], jcfg, tile=TILE, preset="tiny"),
                TD.TiledVolumeScorer(_port_model(tiny), pcfg, tile=TILE, device="cpu"))
    return (JD.DeviceVolumeScorer(*tiny[1], jcfg, preset="tiny"),
            TD.DeviceVolumeScorer(_port_model(tiny), pcfg, device="cpu"))


def _score(scorer, vol, lo, hi):
    if isinstance(scorer, (JD.TiledVolumeScorer, TD.TiledVolumeScorer)):
        return scorer.score(vol)
    return scorer.score(vol, lo, hi)


@pytest.mark.parametrize("layout3d,stem_s2d", FORMS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_scorer_in_each_form_matches_jax(tiny, route, layout3d, stem_s2d):
    """Probabilities against the JAX scorer in the same form, then the
    labelmap at thresholds none of JAX's probabilities lies near:
    ``labelmask`` byte for byte on the device scorer's routes, the packed
    labels of the probabilities on the tiled one (which has no wire)."""
    vol = _volume(SHAPE, seed=sum(SHAPE))
    _, lo, hi = postprocess.liver_mask_extent(_ext_mask(SHAPE))
    jax_sc, port_sc = _scorers(tiny, route, layout3d, stem_s2d)
    assert port_sc.forms == dict(layout3d=layout3d, stem_s2d=stem_s2d)
    want = np.asarray(_score(jax_sc, vol, lo, hi))
    got = _score(port_sc, vol, lo, hi)
    assert tuple(got.shape) == SHAPE + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)

    thresholds = _thresholds(want)
    assert _near_threshold(want, thresholds) == 0
    if route == "tiled":
        got_l = TD.pack_labels(got, *thresholds).numpy()
        want_l = np.asarray(JD._pack_labels(want, *thresholds))
    else:
        jax_sc, port_sc = _scorers(tiny, route, layout3d, stem_s2d, thresholds)
        got_l, want_l = port_sc.labelmask(vol, lo, hi), jax_sc.labelmask(vol, lo, hi)
    assert (got_l == 1).any() and (got_l == 3).any()  # liver-only and tumour voxels
    np.testing.assert_array_equal(got_l, want_l)


def test_forms_follow_the_config():
    """The scorers read the form from the config, the shipped default
    being the space-to-depth stem in the canonical layout; a config without
    the fields gets the direct form."""
    assert TD.forms(InferConfig()) == dict(layout3d="hwdc", stem_s2d=True)
    assert TD.forms(object()) == dict(layout3d="hwdc", stem_s2d=False)
    cfg = InferConfig(layout3d="dhwc", stem_s2d=False)
    scorer = TD.TiledVolumeScorer(HDenseUNet(preset="tiny", device="meta"), cfg, device="meta")
    assert scorer.forms == dict(layout3d="dhwc", stem_s2d=False)
