"""The port's own copies of the JAX package's framework-free files, held to
their originals: the typed config, the NIfTI reader/writer and the host
postprocess with its native core. Also: no import statement of the port,
nor of the scripts that drive it on the card, names JAX or the JAX package.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

from hdenseunet_tpu import native as j_native
from hdenseunet_tpu.core import config as j_config
from hdenseunet_tpu.data import nifti as j_nifti
from hdenseunet_tpu.infer import postprocess as j_post
from hdenseunet_tpu_torch import native as t_native
from hdenseunet_tpu_torch.core import config as t_config
from hdenseunet_tpu_torch.data import nifti as t_nifti
from hdenseunet_tpu_torch.infer import postprocess as t_post

REPO = Path(__file__).resolve().parent.parent
CONFIG_CLASSES = ["DataConfig", "ModelConfig", "TrainConfig", "InferConfig", "Config"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_class_equals_the_original(name):
    port, orig = getattr(t_config, name), getattr(j_config, name)
    assert dataclasses.asdict(port()) == dataclasses.asdict(orig())
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == [
        (f.name, f.type) for f in dataclasses.fields(orig)
    ]


def test_config_json_round_trips_between_the_copies():
    cfg = j_config.Config()
    cfg.model.preset, cfg.train.arch, cfg.infer.window_batch = "tiny", "end2end", 3
    port = t_config.Config.from_json(cfg.to_json())
    assert port.to_json() == cfg.to_json()
    assert port.train.resolved_steps_per_epoch() == cfg.train.resolved_steps_per_epoch()


def _blobs(shape, seed, level):
    """A smooth random field thresholded into blobs of several sizes."""
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.normal(size=shape), 2.0) > level


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    if request.param == "native":
        assert t_native.pp_available() and j_native.pp_available()
    else:
        monkeypatch.setenv("HDENSEUNET_HOST_POSTPROCESS", "scipy")
    return request.param


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_byte_identical_to_the_original(route, seed):
    shape = (40, 36, 24)
    liver, tumor = _blobs(shape, seed, 0.05), _blobs(shape, seed + 10, 0.12)
    ext = _blobs(shape, seed + 20, 0.0).astype(np.int16)
    ext[_blobs(shape, seed + 30, 0.15)] = 2
    assert liver.any() and tumor.any() and (ext == 2).any()
    for fn in ("largest_component", "fill_holes", "dilate"):
        got, want = getattr(t_post, fn)(liver), getattr(j_post, fn)(liver)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    got = t_post.compose_from_masks(liver, tumor, ext)
    want = j_post.compose_from_masks(liver, tumor, ext)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes() and (got == 2).any()
    m_t, lo_t, hi_t = t_post.liver_mask_extent(ext)
    m_j, lo_j, hi_j = j_post.liver_mask_extent(ext)
    assert (lo_t, hi_t) == (lo_j, hi_j) and np.array_equal(m_t, m_j)
    probs = np.random.default_rng(seed).uniform(size=shape + (2,)).astype(np.float32)
    got = t_post.compose_labelmap(probs[..., 0], probs[..., 1], ext)
    want = j_post.compose_labelmap(probs[..., 0], probs[..., 1], ext)
    assert got.tobytes() == want.tobytes()


def test_native_build_is_apart_from_the_jax_packages():
    assert t_native._PP_SRC.read_bytes() == Path(j_native._PP_SRC).read_bytes()
    so = t_native._build(t_native._PP_SRC, "postprocess")
    assert so is not None and so.parent == t_native.BUILD_DIR
    assert so.parent.parent == REPO / "build"


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize(
    "dtype,suffix", [(np.int16, ".nii"), (np.float32, ".nii.gz"), (np.uint8, ".nii")]
)
def test_nifti_reads_back_identically_across_packages(tmp_path, writer, dtype, suffix):
    w, r = (j_nifti, t_nifti) if writer == "jax" else (t_nifti, j_nifti)
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 200, (9, 7, 5)).astype(dtype)
    path = tmp_path / f"v{suffix}"
    w.write(path, vol)
    got, hdr_r = r.read(path)
    want, hdr_w = w.read(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.asarray(got), vol)
    assert [f.name for f in dataclasses.fields(hdr_r)] == [f.name for f in dataclasses.fields(hdr_w)]
    for f in dataclasses.fields(hdr_w):
        assert np.array_equal(np.asarray(getattr(hdr_r, f.name)), np.asarray(getattr(hdr_w, f.name)))
    again = tmp_path / f"again{suffix}"
    r.write(again, got, hdr_r)  # header passthrough in the other package
    assert np.array_equal(w.read(again)[0], vol)


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ("jax", "hdenseunet_tpu"))


@pytest.mark.parametrize(
    "script", ["chip_smoke.py", "profile_serving.py", "profile_train.py", "hdenseunet_tpu_torch"]
)
def test_no_import_statement_names_jax(script):
    """Every import statement, nested ones included, of the port's files and
    of the scripts that drive it on the card."""
    root = REPO / script
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                bad += [(path.name, node.module)] if _forbidden(node.module or "") else []
    assert not bad, bad
