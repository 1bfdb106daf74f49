"""The port's Keras-HDF5 converter (``weights/convert.py``) and its CLI
commands against the JAX package's on CPU.

Files in every layout the reference's loaders read (flat by-name, a
full-model save's ``model_weights`` wrapper, ``make_parallel``'s
``model_1``, the ``denseu161`` and ``auto3d_residual_conv`` submodels of a
two-model save, and Keras-1 leaf names) are written here with h5py from
seeded arrays; the reference's released weights are not in the repository.
"""
import sys

import h5py
import numpy as np
import pytest
import torch

from hdenseunet_tpu.weights import convert as JC
from hdenseunet_tpu_torch import cli
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.train import checkpoint, trainer
from hdenseunet_tpu_torch.weights import convert as TC

LAYOUTS = ["flat", "model_weights", "model_1", "denseu161", "auto3d_residual_conv", "keras1"]
SUBMODEL = {"model_1": "model_1", "denseu161": "denseu161", "auto3d_residual_conv": "auto3d_residual_conv"}
TINY = ["--set", "model.preset", "tiny", "--set", "model.input_size", "32"]


def _layers(seed):
    """{layer: {leaf: array}} of a conv, a BN and a Scale, named like the
    reference graph's layers."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        f"conv1_{seed}": {"kernel": f(3, 3, 4, 8), "bias": f(8)},
        f"conv1_bn_{seed}": {"gamma": f(8), "beta": f(8), "moving_mean": f(8), "moving_variance": f(8) ** 2},
        f"conv1_scale_{seed}": {"gamma": f(8), "beta": f(8)},
    }


def _write_group(g, layers):
    """Keras-2.0.8 save_weights_to_hdf5_group into group g."""
    g.attrs["layer_names"] = [n.encode() for n in layers]
    for lname, leaves in layers.items():
        sub = g.create_group(lname)
        names = []
        for leaf, arr in leaves.items():
            sub.create_dataset(f"{lname}/{leaf}:0", data=arr)
            names.append(f"{lname}/{leaf}:0".encode())
        sub.attrs["weight_names"] = names


def _write(path, layout):
    """An HDF5 file in ``layout``."""
    with h5py.File(path, "w") as f:
        if layout == "flat":
            _write_group(f, _layers(0))
        elif layout == "model_weights":  # a full-model save wraps the weights
            _write_group(f.create_group("model_weights"), _layers(0))
        elif layout == "model_1":  # make_parallel: every layer under model_1
            f.attrs["layer_names"] = [b"input_1", b"model_1", b"concat"]
            f.create_group("input_1").attrs["weight_names"] = []
            _write_group(f.create_group("model_1"), _layers(0))
        elif layout in ("denseu161", "auto3d_residual_conv"):  # two-model save
            mw = f.create_group("model_weights")
            mw.attrs["layer_names"] = [b"denseu161", b"auto3d_residual_conv", b"fianl_conv"]
            _write_group(mw.create_group("denseu161"), _layers(1))
            _write_group(mw.create_group("auto3d_residual_conv"), _layers(2))
            _write_group(mw.create_group("fianl_conv"), {"fianl_conv": _layers(3)["conv1_3"]})
        else:  # Keras-1 leaf names, underscore names and a group without weight_names
            rng = np.random.default_rng(4)
            f.attrs["layer_names"] = [b"bn_k1", b"scale_k1", b"conv_k1", b"nested"]
            bn = f.create_group("bn_k1")
            for leaf in ("gamma", "beta", "running_mean", "running_std"):
                bn.create_dataset(f"bn_k1/{leaf}:0", data=rng.normal(size=5).astype(np.float32))
            bn.attrs["weight_names"] = [f"bn_k1/{l}:0".encode() for l in ("gamma", "beta", "running_mean", "running_std")]
            sc = f.create_group("scale_k1")
            for leaf in ("gamma", "beta"):
                sc.create_dataset(f"scale_k1_{leaf}:0", data=rng.normal(size=5).astype(np.float32))
            sc.attrs["weight_names"] = [b"scale_k1_gamma:0", b"scale_k1_beta:0"]
            conv = f.create_group("conv_k1")  # no weight_names: the datasets are walked
            conv.create_dataset("conv_k1/kernel:0", data=rng.normal(size=(1, 1, 5, 2)).astype(np.float32))
            conv.create_dataset("conv_k1/bias:0", data=np.zeros(2, np.float32))
            _write_group(f.create_group("nested"), {"inner_conv": _layers(5)["conv1_5"]})
    return path


def _assert_trees_equal(got, want):
    assert list(got) == list(want)
    for lname, leaves in want.items():
        assert list(got[lname]) == list(leaves), lname
        for leaf, arr in leaves.items():
            g = got[lname][leaf]
            assert g.dtype == arr.dtype and g.shape == arr.shape and np.array_equal(g, arr), (lname, leaf)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_keras_hdf5_matches_jax(tmp_path, layout):
    path = _write(tmp_path / f"{layout}.h5", layout)
    submodel = SUBMODEL.get(layout)
    want = JC.load_keras_hdf5(path, submodel=submodel)
    assert want and all(want.values())
    _assert_trees_equal(TC.load_keras_hdf5(path, submodel=submodel), want)
    if layout == "keras1":
        assert set(want["bn_k1"]) == {"gamma", "beta", "moving_mean", "moving_variance"}
        assert set(want["nested"]) == set(want["conv_k1"]) == {"kernel", "bias"}  # datasets walked


@pytest.mark.parametrize("layout", ["flat", "model_weights", "denseu161", "keras1"])
def test_convert_checkpoint_writes_the_same_npz(tmp_path, layout):
    path = _write(tmp_path / "w.h5", layout)
    submodel = SUBMODEL.get(layout)
    keys = TC.convert_checkpoint(path, tmp_path / "port" / "w.npz", submodel=submodel)
    assert keys == JC.convert_checkpoint(path, tmp_path / "jax" / "w.npz", submodel=submodel)
    with np.load(tmp_path / "port" / "w.npz") as got, np.load(tmp_path / "jax" / "w.npz") as want:
        assert sorted(got.files) == sorted(want.files) == keys
        for k in keys:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    _assert_trees_equal(TC.load_npz_checkpoint(tmp_path / "port" / "w.npz"),
                        JC.load_npz_checkpoint(tmp_path / "jax" / "w.npz"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_keras_hdf5_reads_back_across_packages(tmp_path, writer):
    layers = {**_layers(6), **_layers(7)}
    params = {n: {l: a for l, a in d.items() if l not in ("moving_mean", "moving_variance")}
              for n, d in layers.items()}
    state = {n: {l: d[l] for l in ("moving_mean", "moving_variance")} for n, d in layers.items() if "moving_mean" in d}
    save, read = (TC.save_keras_hdf5, JC.load_keras_hdf5) if writer == "port" else (JC.save_keras_hdf5, TC.load_keras_hdf5)
    save(tmp_path / "w.h5", params, state)
    got = read(tmp_path / "w.h5")
    assert got.keys() == layers.keys()
    for lname, leaves in layers.items():
        assert got[lname].keys() == leaves.keys()
        assert all(np.array_equal(got[lname][k], v) for k, v in leaves.items()), lname
    # both writers write the same file: the same groups, attrs and datasets
    (TC.save_keras_hdf5 if writer == "jax" else JC.save_keras_hdf5)(tmp_path / "other.h5", params, state)
    with h5py.File(tmp_path / "w.h5") as a, h5py.File(tmp_path / "other.h5") as b:
        assert {k: list(v) for k, v in a.attrs.items()} == {k: list(v) for k, v in b.attrs.items()}
        for lname in layers:
            assert list(a[lname].attrs["weight_names"]) == list(b[lname].attrs["weight_names"])


def test_export_then_convert_through_the_cli(tmp_path, capsys):
    """export-weights writes a port checkpoint's weights as Keras HDF5 that
    the JAX package reads back to the model's own pytree; convert-weights
    turns that file into the .npz that loads into a fresh model."""
    cfg = cli._load_config(None, {"model.preset": "tiny", "model.input_size": "32"})
    st = trainer.create_train_state(cfg, "2d", device="cpu", seed=3)
    checkpoint.Checkpointer(tmp_path / "ck").save(7, st)
    params, state = P.to_numpy(st.model)
    cli.main(["export-weights", str(tmp_path / "ck"), str(tmp_path / "w.h5"), "--arch", "2d",
              "--device", "cpu", *TINY])
    n = sum(len(v) for v in params.values())
    assert f"exported {n} weight arrays (+BN stats)" in capsys.readouterr().out
    got = JC.load_keras_hdf5(tmp_path / "w.h5")
    assert got.keys() == params.keys()
    for lname in params:
        want = {**params[lname], **state.get(lname, {})}
        assert got[lname].keys() == want.keys() and all(np.array_equal(got[lname][k], v) for k, v in want.items())

    cli.main(["convert-weights", str(tmp_path / "w.h5"), str(tmp_path / "w.npz")])
    assert "weight arrays ->" in capsys.readouterr().out
    fresh = trainer.create_train_state(cfg, "2d", device="cpu", seed=4).model
    report = TC.match_to_model(TC.load_npz_checkpoint(tmp_path / "w.npz"), fresh)
    assert len(report["loaded"]) == len(params) and not report["skipped"] and not report["mismatched"]
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), st.model.state_dict().values()))


def test_export_refuses_an_empty_directory(tmp_path):
    (tmp_path / "ck").mkdir()
    with pytest.raises(SystemExit, match="no best checkpoint"):
        cli.main(["export-weights", str(tmp_path / "ck"), str(tmp_path / "w.h5"), "--restore", "best",
                  "--device", "cpu", *TINY])


@pytest.mark.parametrize("command", ["convert-weights", "export-weights"])
def test_without_h5py_the_commands_exit_naming_the_npz_route(tmp_path, monkeypatch, command):
    argv = {"convert-weights": ["convert-weights", str(_write(tmp_path / "w.h5", "flat")), str(tmp_path / "w.npz")],
            "export-weights": ["export-weights", str(tmp_path / "ck"), str(tmp_path / "w.h5"), "--device", "cpu"]}
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises ImportError
    with pytest.raises(SystemExit) as got:
        cli.main(argv[command])
    message = str(got.value)
    assert "h5py" in message and ".npz" in message and "--init-from" in message
    assert not (tmp_path / "w.npz").exists()
    with pytest.raises(ImportError, match="h5py is required"):
        TC.load_keras_hdf5(tmp_path / "w.h5")
