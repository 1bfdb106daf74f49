"""The port's own copies of the JAX package's framework-free files, held to
their originals: the typed config, the NIfTI reader/writer, the host
postprocess with its native core, the offline preparation, the metrics,
the sampler's native core, the Keras-HDF5 converter's functions and the
scorers' window grids. Also: no import statement of the port, nor of the
scripts that drive it on the card, names JAX or the JAX package.
"""
import ast
import dataclasses
import inspect
import textwrap
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

from hdenseunet_tpu import native as j_native
from hdenseunet_tpu.core import config as j_config
from hdenseunet_tpu.data import nifti as j_nifti, preprocess as j_pre
from hdenseunet_tpu.infer import device_pipeline as j_dp, metrics as j_metrics, postprocess as j_post
from hdenseunet_tpu.infer import sliding_window as j_sw
from hdenseunet_tpu.weights import convert as j_convert, parity as j_parity
from hdenseunet_tpu_torch import native as t_native
from hdenseunet_tpu_torch.core import config as t_config
from hdenseunet_tpu_torch.data import nifti as t_nifti, preprocess as t_pre
from hdenseunet_tpu_torch.infer import device_pipeline as t_dp, metrics as t_metrics, postprocess as t_post
from hdenseunet_tpu_torch.infer import sliding_window as t_sw
from hdenseunet_tpu_torch.weights import convert as t_convert, parity as t_parity

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


def _c_function(src: str, name: str) -> str:
    """The text of the C function ``name`` in ``src``, from its signature to
    its closing brace at the start of a line."""
    start = src.index(f"void {name}(")
    return src[start : src.index("\n}\n", start) + 3]


def test_native_build_is_apart_from_the_jax_packages():
    """The port's core keeps the original's labelling and hole fill as they
    are; its dilation, ``pp_dilate_extent``, runs over the mask's grown
    bounding box, and the tests hold its output to scipy and the original."""
    port, orig = t_native._PP_SRC.read_text(), Path(j_native._PP_SRC).read_text()
    for name in ("pp_largest_component", "pp_fill_holes"):
        assert _c_function(port, name) == _c_function(orig, name), name
    assert "void pp_dilate(" not in port and "void pp_dilate_extent(" in port
    so = t_native._build(t_native._PP_SRC, "postprocess")
    assert so is not None and so.parent == t_native.BUILD_DIR
    assert so.parent.parent == REPO / "build"


def test_native_sampler_is_a_copy_built_apart_from_the_jax_packages():
    assert t_native._SRC.read_bytes() == Path(j_native._SRC).read_bytes()
    so = t_native._build(t_native._SRC, "sampler")
    assert so is not None and so.parent == t_native.BUILD_DIR == REPO / "build" / "native"
    assert t_native.available()
    rng = np.random.default_rng(1)
    vol = rng.normal(0, 100, (40, 36, 10)).astype(np.float32)
    seg = rng.integers(0, 3, vol.shape).astype(np.int16)
    kw = dict(mean=48.0, flip_case=5, out_size=48)
    got = t_native.crop_aug_resize(vol, seg, (3, 2, 1), (30, 30, 8), **kw)
    want = j_native.crop_aug_resize(vol, seg, (3, 2, 1), (30, 30, 8), **kw)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def _tree_bytes(root: Path) -> dict:
    """{relative path: array bytes} of every .npy and every array of every
    .npz under root."""
    out = {}
    for p in sorted(root.rglob("*.np[yz]")):
        rel = str(p.relative_to(root))
        if p.suffix == ".npy":
            a = np.load(p)
            out[rel] = (a.dtype.str, a.shape, a.tobytes())
        else:
            with np.load(p) as z:
                for k in z.files:
                    out[f"{rel}:{k}"] = (z[k].dtype.str, z[k].shape, z[k].tobytes())
    return out


@pytest.mark.parametrize("fn", ["synthesize", "run", "extract_coords", "clip_hu"])
def test_preprocess_equals_the_original(tmp_path, fn):
    rng = np.random.default_rng(2)
    if fn == "synthesize":
        for mod, out in ((t_pre, "port"), (j_pre, "jax")):
            mod.synthesize(tmp_path / out, num_volumes=2, shape=(40, 36, 12), seed=3)
    elif fn == "run":
        raw = tmp_path / "raw"
        raw.mkdir()
        for i in range(2):
            vol = rng.normal(0, 300, (20, 18, 6)).astype(np.float32)
            t_nifti.write(raw / f"volume-{i}.nii", vol)
            t_nifti.write(raw / f"segmentation-{i}.nii", rng.integers(0, 3, vol.shape).astype(np.int16))
        for mod, out in ((t_pre, "port"), (j_pre, "jax")):
            mod.run(raw, tmp_path / out, num_volumes=2, log=lambda *_: None)
    if fn in ("synthesize", "run"):
        got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
        assert got.keys() == want.keys() and len(got) == 2 * (2 + 4) and got == want
        ds_t, ds_j = t_pre.PreparedDataset(tmp_path / "port"), j_pre.PreparedDataset(tmp_path / "jax")
        assert ds_t.indices == ds_j.indices == [0, 1]
        assert np.array_equal(ds_t.volume(1), ds_j.volume(1))
    elif fn == "extract_coords":
        seg = rng.integers(0, 3, (12, 10, 8)).astype(np.int16)
        for box in ("liver", "any"):
            got, want = t_pre.extract_coords(seg, box_labels=box), j_pre.extract_coords(seg, box_labels=box)
            assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
        empty = np.zeros((4, 5, 6), np.int16)
        assert np.array_equal(t_pre.extract_coords(empty)["box_max"], j_pre.extract_coords(empty)["box_max"])
    else:
        vol = rng.normal(0, 400, (9, 8, 7))
        assert t_pre.clip_hu(vol).tobytes() == j_pre.clip_hu(vol).tobytes()


@pytest.mark.parametrize(
    "fn", ["dice", "dice_per_class", "global_dice", "voe", "rvd", "metrics_per_class"]
)
def test_metrics_equal_the_original(fn):
    rng = np.random.default_rng(3)
    a = [rng.integers(0, 3, (10, 9, 8)) for _ in range(3)]
    b = [rng.integers(0, 3, (10, 9, 8)) for _ in range(3)]
    empty = np.zeros((10, 9, 8), np.int64)
    cases = {
        "dice": [(a[0] >= 1, b[0] >= 1), (empty, empty)],
        "voe": [(a[0] == 2, b[0] == 2), (empty, empty)],
        "rvd": [(a[1] == 2, b[1] == 2), (a[1], empty), (empty, empty)],
        "dice_per_class": [(a[0], b[0]), (empty, b[1])],
        "metrics_per_class": [(a[2], b[2]), (empty, empty)],
        "global_dice": [(a, b), ([empty], [empty])],
    }[fn]
    for args in cases:
        got, want = getattr(t_metrics, fn)(*args), getattr(j_metrics, fn)(*args)
        assert got == want, (fn, got, want)


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


def _code(fn) -> str:
    """fn's statements without its docstring and without the h5py guard
    (the JAX module imports h5py once at the top, the port in the function),
    as an AST dump."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    body = [
        st for i, st in enumerate(tree.body)
        if not (i == 0 and isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant))
        and "h5py" not in ast.unparse(st).split("with ")[0]
    ]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("module,name", [
    ("convert", "_decode"), ("convert", "_parse_leaf"), ("convert", "_read_layer_group"),
    ("convert", "load_keras_hdf5"), ("convert", "convert_checkpoint"), ("convert", "save_keras_hdf5"),
    ("device_pipeline", "tile_origins"), ("sliding_window", "window_starts"),
    ("parity", "compare_dumps"),
])
def test_copied_function_equals_the_original(module, name):
    port, orig = {"convert": (t_convert, j_convert), "device_pipeline": (t_dp, j_dp),
                  "sliding_window": (t_sw, j_sw), "parity": (t_parity, j_parity)}[module]
    assert _code(getattr(port, name)) == _code(getattr(orig, name))


def test_converter_tables_and_leaf_parsing_equal_the_originals():
    for name in ("SUBMODEL_2D", "SUBMODEL_3D", "MULGPU_GROUP", "_LEAF_ALIASES", "_STATE_LEAVES"):
        assert getattr(t_convert, name) == getattr(j_convert, name), name
    for wname in ("conv1/kernel:0", "conv1_scale_gamma:0", "bn/running_std:0", "a/b/beta", "x_W:0", "k"):
        try:
            want = j_convert._parse_leaf(wname)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(" in ")[0]):
                t_convert._parse_leaf(wname)
            continue
        assert t_convert._parse_leaf(wname) == want
    assert t_convert._decode(b"conv1") == j_convert._decode(b"conv1") == "conv1"
    assert t_dp.tile_origins(512, 256, 170) == j_dp.tile_origins(512, 256, 170) == [0, 170, 256]
    assert t_parity.TAPS == j_parity.TAPS


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ("jax", "hdenseunet_tpu"))


@pytest.mark.parametrize(
    "script",
    ["chip_smoke.py", "profile_serving.py", "profile_train.py", "profile_feed.py", "compare_train_steps.py",
     "compare_cc.py", "compare_k5.py", "bench_torch.py", "hdenseunet_tpu_torch"],
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
