"""The port's serving path against the JAX package on CPU: window grid,
scorer probabilities, labelmasks and the end-to-end segment.

Tiny-preset weights come from the JAX ``hybrid.init`` and reach the port
through the parameter bridge. Thresholds for the labelmap tests are taken
from quantiles of JAX's own probabilities, so liver and tumor voxels both
occur (random tiny weights stay below the shipped 0.5 / 0.9).
"""
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.config import Config as JConfig, InferConfig as JInferConfig
from hdenseunet_tpu.infer import device_pipeline as JD
from hdenseunet_tpu.infer import sliding_window as JS
from hdenseunet_tpu.infer.predictor import VolumePredictor as JVolumePredictor
from hdenseunet_tpu.models import hybrid as JH
from hdenseunet_tpu_torch.core.config import Config, InferConfig
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.data import nifti
from hdenseunet_tpu_torch.infer import postprocess
from hdenseunet_tpu_torch.infer import device_pipeline as TD
from hdenseunet_tpu_torch.infer.predictor import VolumePredictor, predict_directory
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

REPO = Path(__file__).resolve().parent.parent
# float32 on both sides, both scorers running the shipped space-to-depth
# stem; convs sum in another order: probabilities in [0, 1] agree to a few
# fp32 ulps per layer
PROB_TOL = 1e-5
LIVER, TUMOR = 1, 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    params, state = JH.init(jax.random.key(0), input_size=32, input_cols=8, batch=1, preset="tiny")
    return params, state


def _port_model(tiny):
    return from_numpy(HDenseUNet(preset="tiny"), *tiny)


def _volume(shape, seed):
    """Integer HU in the preprocessing window, mean-subtracted like serving."""
    rng = np.random.default_rng(seed)
    return rng.integers(-200, 251, shape).astype(np.float32) - 48.0


# --------------------------------------------------------------------------
# grid helpers and wire packing: copies pinned to the originals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("z", [8, 9, 28, 40, 97, 200])
def test_grid_helpers_match_jax(z):
    cfg = JInferConfig()
    for lo in range(0, z, max(1, z // 7)):
        for hi in range(lo, z, max(1, z // 5)):
            starts = TD.window_starts(z, lo, hi, cfg)
            assert starts == JS.window_starts(z, lo, hi, cfg)
            rel = [s - min(starts) for s in starts]
            for wb in (1, 3, 8):
                zp = -(-max(z, 8) // 16) * 16
                assert TD.plan_windows(zp, cfg) == JD.plan_windows(zp, cfg)
                cap = -(-TD.plan_windows(zp, cfg) // wb) + 1
                for got, want in zip(
                    TD.make_grid_structured(rel, wb, cfg.window_stride, max_runs=cap),
                    JD.make_grid_structured(rel, wb, cfg.window_stride, max_runs=cap),
                ):
                    np.testing.assert_array_equal(got, want)
                n = -(-len(set(rel)) // wb)
                for got, want in zip(TD.make_grid(rel, wb, n), JD.make_grid(rel, wb, n)):
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(512, 512, 96), (64, 64, 28), (48, 40, 28), (33, 65, 200)])
def test_plan_matches_jax(shape):
    cfg = JInferConfig()
    _, _, z = shape
    jax_sc = JD.DeviceVolumeScorer(None, None, cfg)
    port_sc = TD.DeviceVolumeScorer(HDenseUNet(preset="tiny", device="meta"), cfg, device="meta")
    for lo, hi in [(0, z - 1), (z // 4, z // 2), (z - 3, z - 1)]:
        want = jax_sc.plan(shape, lo, hi)
        got = port_sc.plan(shape, lo, hi)
        for key in ("z_lo", "z", "zp", "xp", "yp", "wb"):
            assert got[key] == want[key], key
        np.testing.assert_array_equal(got["starts"], want["starts"])
        np.testing.assert_array_equal(got["weights"], want["weights"])


def test_label_packing_matches_jax():
    rng = np.random.default_rng(11)
    score = rng.uniform(size=(9, 7, 16, 3)).astype(np.float32)
    want = np.asarray(JD._pack_labels(score, 0.4, 0.7))
    got = TD.pack_labels(torch.from_numpy(score), 0.4, 0.7)
    np.testing.assert_array_equal(got.numpy(), want)
    for pack_z in (None, 12):
        packed = TD.pack2bits(got, pack_z=pack_z)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(JD._pack2bits(want, pack_z=pack_z)))
        np.testing.assert_array_equal(TD.unpack2bits(packed.numpy()), want[:, :, :pack_z])
        np.testing.assert_array_equal(
            TD.unpack2bits(packed.numpy()), JD._unpack2bits(np.asarray(packed.numpy()))
        )


@pytest.mark.parametrize("wb,cols,stride", [(8, 8, 2), (3, 8, 2), (4, 6, 1)])
def test_assembly_map_picks_each_windows_stacks(wb, cols, stride):
    """Row asm[j, p] of a run's 2D batch is the stack window j needs at
    position p: interior rows are centred on s0 + stride*j + p, edge rows
    are the window's own replicated edges."""
    ni = (wb - 1) * stride + cols - 2
    asm = TD.assembly_map(wb, cols, stride)
    for j in range(wb):
        assert asm[j, 0] == ni + j and asm[j, cols - 1] == ni + wb + j
        for p in range(1, cols - 1):
            assert asm[j, p] + 1 == stride * j + p  # interior row r is centre s0+1+r


# --------------------------------------------------------------------------
# scorer and segment against the JAX package
# --------------------------------------------------------------------------


def _ext_mask(shape):
    ext = np.zeros(shape, np.int16)
    ext[8:56, 8:36, 6:22] = 1
    ext[20:30, 12:20, 10:14] = 2  # tumor label merges into the mask
    return ext


@pytest.fixture(scope="module")
def jax_probs(tiny):
    """JAX scorer probabilities per test volume shape (shipped InferConfig),
    over the z range the external liver mask gives."""
    scorer = JD.DeviceVolumeScorer(*tiny, JInferConfig(), preset="tiny")
    out = {}
    for shape in [(64, 64, 28), (48, 40, 28)]:
        vol = _volume(shape, seed=sum(shape))
        _, lo, hi = postprocess.liver_mask_extent(_ext_mask(shape))
        out[shape] = (vol, lo, hi, np.asarray(scorer.score(vol, lo, hi)))
    return out


@pytest.mark.parametrize("shape", [(64, 64, 28), (48, 40, 28)])
def test_scorer_probabilities_match_jax(tiny, jax_probs, shape):
    vol, lo, hi, want = jax_probs[shape]
    scorer = TD.DeviceVolumeScorer(_port_model(tiny), InferConfig(), device="cpu")
    got = scorer.score(vol, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)


def _threshold_near(values, q, tol):
    """A threshold near quantile q of ``values`` with none of them within tol."""
    v = np.unique(values)
    k = int(q * (len(v) - 1))
    while v[k + 1] - v[k] <= 2 * tol:
        k += 1
    return float((v[k] + v[k + 1]) / 2)


def _thresholds(probs):
    scored = probs[..., 0] > 0  # outside the scored z range all channels are 0
    return (
        _threshold_near(probs[..., LIVER][scored], 0.6, PROB_TOL),
        _threshold_near(probs[..., TUMOR][scored], 0.9, PROB_TOL),
    )


def _near_threshold(probs, thresholds):
    return sum(
        int((np.abs(probs[..., ch] - t) <= PROB_TOL).sum())
        for ch, t in zip((LIVER, TUMOR), thresholds)
    )


@pytest.mark.parametrize("shape", [(64, 64, 28), (48, 40, 28)])
def test_labelmask_byte_identical_to_jax(tiny, jax_probs, shape):
    vol, lo, hi, probs = jax_probs[shape]
    liver_t, tumor_t = _thresholds(probs)
    assert _near_threshold(probs, (liver_t, tumor_t)) == 0
    jcfg = JInferConfig(thres_liver=liver_t, thres_tumor=tumor_t)
    pcfg = InferConfig(thres_liver=liver_t, thres_tumor=tumor_t)
    want = JD.DeviceVolumeScorer(*tiny, jcfg, preset="tiny").labelmask(vol, lo, hi)
    got = TD.DeviceVolumeScorer(_port_model(tiny), pcfg, device="cpu").labelmask(vol, lo, hi)
    assert got.dtype == np.uint8 and got.shape == shape
    assert (got == 1).any() and (got == 3).any()  # liver-only and tumor voxels
    np.testing.assert_array_equal(got, want)


def _configs(thresholds):
    jcfg = JConfig()
    jcfg.model.preset = "tiny"
    jcfg.infer = dataclasses.replace(jcfg.infer, thres_liver=thresholds[0], thres_tumor=thresholds[1])
    pcfg = Config()
    pcfg.model.preset = "tiny"
    pcfg.infer = dataclasses.replace(pcfg.infer, thres_liver=thresholds[0], thres_tumor=thresholds[1])
    return jcfg, pcfg


@pytest.fixture(scope="module")
def segment_case(tiny, jax_probs):
    vol, _, _, probs = jax_probs[(64, 64, 28)]  # the z range segment() derives
    thresholds = _thresholds(probs)
    assert _near_threshold(probs, thresholds) == 0
    jcfg, pcfg = _configs(thresholds)
    return vol + 48.0, _ext_mask(vol.shape), jcfg, pcfg, JVolumePredictor(*tiny, jcfg)


def test_segment_byte_identical_to_jax(tiny, segment_case):
    vol, ext, _, pcfg, jax_vp = segment_case
    want = jax_vp.segment(vol, ext)
    got = VolumePredictor(_port_model(tiny), pcfg, device="cpu").segment(vol, ext)
    assert got.dtype == np.uint8 and got.shape == vol.shape
    assert (got == 1).any() and (got == 2).any()
    np.testing.assert_array_equal(got, want)


def test_predict_directory_matches_jax_segment(tiny, segment_case, tmp_path):
    vol0, ext, _, pcfg, jax_vp = segment_case
    data_dir, mask_dir, out_dir = tmp_path / "d", tmp_path / "m", tmp_path / "o"
    data_dir.mkdir(), mask_dir.mkdir()
    vols = [vol0, _volume(vol0.shape, seed=5) + 48.0]
    for i, vol in enumerate(vols):
        nifti.write(data_dir / f"test-volume-{i}.nii", vol)
        nifti.write(mask_dir / f"test-volume-{i}-ori.nii", ext)
    times = predict_directory(
        _port_model(tiny), pcfg, data_dir=data_dir, liver_mask_dir=mask_dir,
        save_dir=out_dir, num_volumes=2, device="cpu", log=lambda *a: None,
    )
    assert len(times) == 2
    for i, vol in enumerate(vols):
        got, _ = nifti.read(out_dir / f"test-segmentation-{i}.nii")
        np.testing.assert_array_equal(np.asarray(got), jax_vp.segment(vol, ext), err_msg=f"vol {i}")


@pytest.mark.parametrize("field,value", [("device_resident", False)])
def test_unported_serving_options_raise(field, value):
    """No serving option raises any more: the host loop (device_resident
    False) has been ported since, and test_torch_window_predictor.py tests
    what it does."""
    from hdenseunet_tpu_torch.infer.sliding_window import WindowPredictor

    cfg = Config()
    cfg.model.preset = "tiny"
    cfg.infer = dataclasses.replace(cfg.infer, **{field: value})
    vp = VolumePredictor(HDenseUNet(preset="tiny", device="meta"), cfg, device="meta")
    assert isinstance(vp.windows, WindowPredictor)


# --------------------------------------------------------------------------
# the scorer's other modes and the device postprocess
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,field", [((64, 64, 28), "dedup_2d"), ((48, 40, 28), "dedup_2d"),
                    ((64, 64, 28), "shared_2d"), ((48, 40, 28), "shared_2d")],
)
def test_other_scoring_paths_match_jax(tiny, jax_probs, shape, field):
    """The exact per-window path (dedup_2d=False) and the shared-2D fast mode
    against the JAX scorer under the same setting; the per-window path also
    against the shipped dedup path, which is exact too."""
    vol, lo, hi, dedup_probs = jax_probs[shape]
    value = field == "shared_2d"
    jcfg = dataclasses.replace(JInferConfig(), **{field: value})
    want = np.asarray(JD.DeviceVolumeScorer(*tiny, jcfg, preset="tiny").score(vol, lo, hi))
    scorer = TD.DeviceVolumeScorer(
        _port_model(tiny), dataclasses.replace(InferConfig(), **{field: value}), device="cpu"
    )
    got = scorer.score(vol, lo, hi)
    assert tuple(got.shape) == shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)
    if field == "dedup_2d":
        np.testing.assert_allclose(got.numpy(), dedup_probs, atol=PROB_TOL, rtol=0)
    else:  # windows of 4 batches (device_pipeline.py:295-299)
        assert scorer.plan(vol.shape, lo, hi)["wb"] == 4


@pytest.mark.parametrize("shape", [(64, 64, 28), (48, 40, 28)])
def test_uint8_wire_and_outputs_match_jax(tiny, jax_probs, shape):
    """wire_bits=8: the labelmask byte for byte; score's 'packed' output;
    the digest and predict_volume within the probabilities' tolerance."""
    vol, lo, hi, probs = jax_probs[shape]
    liver_t, tumor_t = _thresholds(probs)
    jcfg = JInferConfig(thres_liver=liver_t, thres_tumor=tumor_t, wire_bits=8)
    pcfg = InferConfig(thres_liver=liver_t, thres_tumor=tumor_t, wire_bits=8)
    jax_sc = JD.DeviceVolumeScorer(*tiny, jcfg, preset="tiny")
    port_sc = TD.DeviceVolumeScorer(_port_model(tiny), pcfg, device="cpu")
    got = port_sc.labelmask(vol, lo, hi)
    np.testing.assert_array_equal(got, jax_sc.labelmask(vol, lo, hi))
    assert (got == 1).any() and (got == 3).any()
    np.testing.assert_array_equal(
        port_sc.score(vol, lo, hi, output="packed").numpy(),
        np.asarray(jax_sc.score(vol, lo, hi, output="packed")),
    )
    digest, want = port_sc.summarize(vol, lo, hi), jax_sc.summarize(vol, lo, hi)
    # sums of n probabilities, each within PROB_TOL, in another order
    n = np.prod(jax_probs[shape][3].shape[:3])
    np.testing.assert_allclose(digest[:2], want[:2], atol=PROB_TOL * n, rtol=1e-6)
    np.testing.assert_allclose(digest[2], want[2], atol=PROB_TOL, rtol=0)
    for got_p, want_p in zip(port_sc.predict_volume(vol, lo, hi), jax_sc.predict_volume(vol, lo, hi)):
        np.testing.assert_allclose(got_p, want_p, atol=PROB_TOL, rtol=0)


@pytest.fixture(scope="module")
def host_labelmaps(tiny, segment_case):
    """The JAX predictor's labelmaps with the host postprocess, and the
    port's, for the segment case and one with xy compute padding."""
    vol, ext, jcfg, pcfg, jax_vp = segment_case
    vol2 = _volume((48, 40, 28), seed=9) + 48.0
    ext2 = _ext_mask((48, 40, 28))
    out = {}
    for key, v, e in (("64", vol, ext), ("48", vol2, ext2)):
        want = jax_vp.segment(v, e)
        np.testing.assert_array_equal(
            VolumePredictor(_port_model(tiny), pcfg, device="cpu").segment(v, e), want
        )
        out[key] = (v, e, want)
    return out


@pytest.mark.parametrize("chunk_iters", [0, 2])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("device_pp", [False, True])
def test_predictor_postprocess_matrix(tiny, segment_case, host_labelmaps, device_pp, sparse, chunk_iters):
    """Labelmaps byte-identical to the JAX VolumePredictor's under the same
    settings and to the host-postprocess path, for every combination of
    device_postprocess, sparse_wire and postprocess_chunk_iters."""
    _, _, jcfg, pcfg, _ = segment_case
    knobs = dict(device_postprocess=device_pp, sparse_wire=sparse, postprocess_chunk_iters=chunk_iters)
    jcfg, pcfg = copy.deepcopy(jcfg), copy.deepcopy(pcfg)
    jcfg.infer = dataclasses.replace(jcfg.infer, **knobs)
    pcfg.infer = dataclasses.replace(pcfg.infer, **knobs)
    cases = host_labelmaps.items() if device_pp and sparse and chunk_iters else [("64", host_labelmaps["64"])]
    port_vp = VolumePredictor(_port_model(tiny), pcfg, device="cpu")
    jax_vp = JVolumePredictor(*tiny, jcfg)
    for key, (vol, ext, host) in cases:
        got = port_vp.segment(vol, ext)
        assert got.dtype == np.uint8 and (got == 1).any() and (got == 2).any()
        np.testing.assert_array_equal(got, host, err_msg=key)
        np.testing.assert_array_equal(got, jax_vp.segment(vol, ext), err_msg=key)


def test_port_imports_no_jax():
    """Every module of the port loads without JAX or the JAX package. A
    subprocess, because this test process imported both already."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "hdenseunet_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"mods = [importlib.import_module(m) for m in {modules!r}]\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'hdenseunet_tpu')\n"
        "             or m.startswith(('jax.', 'hdenseunet_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules) >= 30
