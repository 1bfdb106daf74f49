"""The port's window-parallel scoring (``mesh=`` on DeviceVolumeScorer,
WindowPredictor and VolumePredictor) on two gloo ranks against the JAX
package's scorers on a 2-device mesh and against the port's single process,
on the CPU.

Two ranks (this file run as a script, launched by
``test_torch_parallel.run_ranks``) score one seeded 48x40x28 volume with
tiny-preset weights from the JAX ``hybrid.init``, window_batch 8 (4 windows
per rank): the dedup-2D and per-window scorers and the host-loop
WindowPredictor hold to JAX's mesh scorers at atol 1e-5
(tests/test_infer.py:248-262, :381-396), the dedup-2D one also with the
d-major 3D branch; the labelmask and the segmented
labelmap equal the port's single process's byte for byte, at thresholds
with no probability within 1e-5 of them; a window_batch the ranks do not
divide, and the shared-2D mode, raise.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core import mesh as M
from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
from hdenseunet_tpu_torch.infer.sliding_window import WindowPredictor
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from test_torch_parallel import join, run_ranks

SHAPE = (48, 40, 28)
PROB_TOL = 1e-5  # float32 both sides, as tests/test_torch_infer.py
MEAN = 48.0  # InferConfig.mean: segment() subtracts it
# the mesh scorers held to JAX's: InferConfig fields (the d-major 3D branch
# with the direct stem besides the shipped form)
SCORERS = {
    "dedup": {}, "per_window": dict(dedup_2d=False),
    "dedup_dhwc": dict(layout3d="dhwc", stem_s2d=False),
}


def volume_case():
    """Integer HU in the preprocessing window (mean-subtracted) and an
    external liver mask whose z extent is (lo, hi)."""
    vol = np.random.default_rng(sum(SHAPE)).integers(-200, 251, SHAPE).astype(np.float32) - MEAN
    ext = np.zeros(SHAPE, np.int16)
    ext[8:40, 8:30, 6:22] = 1
    ext[20:30, 12:20, 10:14] = 2
    return vol, ext, 6, 21


def thresholds(probs, tol=PROB_TOL):
    """Liver and tumour thresholds near the 0.6 and 0.9 quantiles of the
    scored voxels' probabilities, none of them within ``tol``."""
    scored = probs[..., 0] > 0
    out = []
    for ch, q in ((1, 0.6), (2, 0.9)):
        v = np.unique(probs[..., ch][scored])
        k = int(q * (len(v) - 1))
        while v[k + 1] - v[k] <= 2 * tol:
            k += 1
        out.append(float((v[k] + v[k + 1]) / 2))
    return tuple(out)


def port_model(init):
    return from_numpy(HDenseUNet(preset="tiny"), *init)


def predictor_config(thres) -> Config:
    cfg = Config()
    cfg.model.preset = "tiny"
    cfg.infer = dataclasses.replace(cfg.infer, thres_liver=thres[0], thres_tumor=thres[1])
    return cfg


def worker(job: dict) -> None:
    join(job)
    init = torch.load(job["inputs"], weights_only=False)
    mesh = M.make_mesh("cpu")
    vol, ext, lo, hi = volume_case()
    out = {}
    for name, knobs in SCORERS.items():
        scorer = DeviceVolumeScorer(port_model(init), InferConfig(**knobs), device="cpu", mesh=mesh)
        out[name] = scorer.score(vol, lo, hi).numpy()
    out["window"] = np.stack(
        WindowPredictor(port_model(init), InferConfig(), device="cpu", mesh=mesh).predict_volume(vol, lo, hi),
        axis=-1,
    )
    out["thresholds"] = thres = thresholds(out["dedup"])
    cfg = InferConfig(thres_liver=thres[0], thres_tumor=thres[1])
    scorer = DeviceVolumeScorer(port_model(init), cfg, device="cpu", mesh=mesh)
    out["labelmask"] = scorer.labelmask(vol, lo, hi)
    out["segment"] = VolumePredictor(
        port_model(init), predictor_config(thres), device="cpu", mesh=mesh
    ).segment(vol + MEAN, ext)
    out["errors"] = {}
    for name, make in (
        ("scorer", lambda: DeviceVolumeScorer(port_model(init), InferConfig(window_batch=3), device="cpu",
                                              mesh=mesh)),
        ("window", lambda: WindowPredictor(port_model(init), InferConfig(window_batch=3), device="cpu",
                                           mesh=mesh)),
        ("shared_2d", lambda: DeviceVolumeScorer(port_model(init), InferConfig(shared_2d=True), device="cpu",
                                                 mesh=mesh)),
    ):
        try:
            make()
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    torch.save(out, job["out"])
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def init():
    import jax

    from hdenseunet_tpu.models import hybrid as JH

    tree = JH.init(jax.random.key(0), input_size=32, input_cols=8, batch=1, preset="tiny")
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def ranks(init, tmp_path_factory):
    """The two ranks, started first and run beside the JAX scorers."""
    tmp = tmp_path_factory.mktemp("dp_infer")
    torch.save(init, tmp / "inputs.pt")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(run_ranks, Path(__file__), tmp, inputs=str(tmp / "inputs.pt"))
    pool.shutdown()


def jax_mesh():
    import jax

    from hdenseunet_tpu.core.mesh import make_mesh

    return make_mesh(jax.devices()[:2])


@pytest.mark.parametrize("path", list(SCORERS))
def test_device_scorer_matches_jax_mesh_scorer(init, ranks, path):
    from hdenseunet_tpu.core.config import InferConfig as JInferConfig
    from hdenseunet_tpu.infer import device_pipeline as JD

    vol, _, lo, hi = volume_case()
    cfg = JInferConfig(**SCORERS[path])
    want = np.asarray(JD.DeviceVolumeScorer(*init, cfg, preset="tiny", mesh=jax_mesh()).score(vol, lo, hi))
    a, b = (out[path] for out in ranks.result())
    assert np.array_equal(a, b)  # every rank holds the same scores
    assert a.shape == SHAPE + (3,) and a[..., 0].max() > 0
    np.testing.assert_allclose(a, want, atol=PROB_TOL, rtol=0)


def test_window_predictor_matches_jax_mesh_predictor(init, ranks):
    from hdenseunet_tpu.core.config import InferConfig as JInferConfig
    from hdenseunet_tpu.infer.sliding_window import WindowPredictor as JWindowPredictor

    vol, _, lo, hi = volume_case()
    want = np.stack(
        JWindowPredictor(*init, JInferConfig(), preset="tiny", mesh=jax_mesh()).predict_volume(vol, lo, hi),
        axis=-1,
    )
    a, b = (out["window"] for out in ranks.result())
    assert np.array_equal(a, b)
    assert a.shape == SHAPE + (2,) and a.max() > 0
    np.testing.assert_allclose(a, want, atol=PROB_TOL, rtol=0)


def test_labelmask_and_segment_equal_one_process(init, ranks):
    """Two ranks' labelmask and labelmap are the single process's, byte for
    byte, at thresholds no probability lies within 1e-5 of."""
    vol, ext, lo, hi = volume_case()
    outs = ranks.result()
    thres = outs[0]["thresholds"]
    one = DeviceVolumeScorer(port_model(init), InferConfig(), device="cpu").score(vol, lo, hi).numpy()
    assert thresholds(one) == thres
    cfg = InferConfig(thres_liver=thres[0], thres_tumor=thres[1])
    mask = DeviceVolumeScorer(port_model(init), cfg, device="cpu").labelmask(vol, lo, hi)
    labels = VolumePredictor(port_model(init), predictor_config(thres), device="cpu").segment(vol + MEAN, ext)
    assert (mask == 1).any() and (mask == 3).any() and (labels == 2).any()
    for out in outs:
        np.testing.assert_array_equal(out["labelmask"], mask)
        np.testing.assert_array_equal(out["segment"], labels)


def test_window_batch_the_ranks_do_not_divide_raises(ranks):
    for out in ranks.result():
        errors = out["errors"]
        assert errors["scorer"] == errors["window"] == (
            "window_batch 3 is not a multiple of the mesh's 2 ranks")
        assert errors["shared_2d"] == "the shared-2D mode takes no mesh"


def test_one_rank_mesh_scores_as_no_mesh(init):
    """A one-rank mesh (no process group) scores exactly as no mesh, the
    shared-2D mode included."""
    vol, _, lo, hi = volume_case()
    for cfg in (InferConfig(), InferConfig(shared_2d=True, window_batch=3)):
        want = DeviceVolumeScorer(port_model(init), cfg, device="cpu").score(vol, lo, hi)
        scorer = DeviceVolumeScorer(port_model(init), cfg, device="cpu", mesh=M.make_mesh("cpu"))
        got = scorer.score(vol, lo, hi)
        assert torch.equal(got, want)


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))
