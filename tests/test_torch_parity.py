"""The port's activation-parity tool against the JAX package's.

Weights come from the JAX ``*.init`` and reach the port through the
parameter bridge (or through one ``.npz`` both packages read); the inputs are
the same numpy draws. The taps must carry the JAX names and shapes and match
its values at the goldens' bar; ``compare`` must give the JAX verdicts and
exit codes; ``main dump`` must write the JAX input byte for byte.
"""
import functools

import numpy as np
import pytest
import torch

import jax
from hdenseunet_tpu.models import denseunet2d as J2, denseunet3d as J3, hybrid as JH
from hdenseunet_tpu.weights import parity as JP
from hdenseunet_tpu_torch.models import denseunet2d as T2, denseunet3d as T3
from hdenseunet_tpu_torch.weights import parity as TP

# the goldens' own bar (tests/test_goldens.py, tests/test_torch_models.py)
GOLDEN_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.cache
def _init(which):
    """(params, state) of the tiny JAX model and its input."""
    rng = np.random.default_rng(1234)
    if which == "2d":
        p, s = J2.init(jax.random.key(7), input_size=32, **J2.PRESETS["tiny"])
        return p, s, rng.normal(0, 50, (2, 32, 32, 3)).astype(np.float32)
    if which == "3d":
        p, s = J3.init(jax.random.key(8), input_size=32, input_cols=8, channels=4, **J3.PRESETS["tiny"])
        return p, s, rng.normal(0, 50, (1, 32, 32, 8, 4)).astype(np.float32)
    p, s = JH.init(jax.random.key(9), input_size=32, input_cols=8, preset="tiny")
    return p, s, rng.normal(0, 50, (1, 32, 32, 8, 1)).astype(np.float32)


DUMPS = {
    "2d": (JP.dump_activations, TP.dump_activations, ["relu1", "concat_2_2", "concat_3_2", "concat_4_2",
                                                      "relu5_blk", "ac_up4", "dense167classifer"]),
    "3d": (JP.dump_activations_3d, TP.dump_activations_3d, ["3dconcat_2_1", "3dconcat_3_1", "3dconcat_4_2",
                                                            "3drelu5_blk", "3dac_up4", "3dclassifer"]),
    "hybrid": (JP.dump_activations_hybrid, TP.dump_activations_hybrid,
               ["res2d", "fea2d", "feat3d", "2d3dclassifer"]),
}


@pytest.mark.parametrize("which", list(DUMPS))
def test_taps_match_jax(which):
    p, s, x = _init(which)
    jax_dump, port_dump, names = DUMPS[which]
    want = jax_dump(p, s, x, preset="tiny")
    got = port_dump(p, s, x, preset="tiny", device="cpu")
    assert list(got) == list(want) and sorted(got) == sorted(names)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == np.float32 and g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **GOLDEN_TOL, err_msg=name)


def _write_dumps(tmp_path, case):
    rng = np.random.default_rng(5)
    ref = {k: rng.normal(0, 3, (2, 4, 4, c)).astype(np.float32) for k, c in (("a", 3), ("b", 5))}
    other = {k: v.copy() for k, v in ref.items()}
    if case == "near":
        other["a"] += 0.9e-3 * np.abs(ref["a"]).max()
    elif case == "far":
        other["b"][0, 0, 0, 0] += 0.2
    elif case == "shape":
        other["a"] = other["a"][:1]
    elif case == "one_side":
        other["extra"] = np.zeros(3, np.float32)
        del other["b"]
    np.savez(tmp_path / "a.npz", **other)
    np.savez(tmp_path / "b.npz", **ref)
    return str(tmp_path / "a.npz"), str(tmp_path / "b.npz")


@pytest.mark.parametrize("case", ["same", "near", "far", "shape", "one_side"])
def test_compare_dumps_matches_jax(tmp_path, case):
    a, b = _write_dumps(tmp_path, case)
    logs = {"jax": [], "port": []}
    want = JP.compare_dumps(a, b, log=logs["jax"].append)
    got = TP.compare_dumps(a, b, log=logs["port"].append)
    assert bool(got) == bool(want) and logs["port"] == logs["jax"]
    assert bool(want) == (case in ("same", "near", "one_side"))
    codes = []
    for main in (JP.main, TP.main):
        with pytest.raises(SystemExit) as e:
            main(["compare", a, b])
        codes.append(e.value.code)
    assert codes[0] == codes[1] == (0 if want else 1)


def test_compare_tolerances_are_the_cli_flags(tmp_path):
    a, b = _write_dumps(tmp_path, "near")
    for main in (JP.main, TP.main):
        with pytest.raises(SystemExit) as e:
            main(["compare", a, b, "--rtol", "1e-4", "--atol", "0"])
        assert e.value.code == 1


def _tiny_everywhere(monkeypatch):
    """Both packages' ``main`` build the full preset; shrink both to tiny so
    the two CLIs run the same small models."""
    for mod in (J2, J3, T2, T3):
        monkeypatch.setitem(mod.PRESETS, "full", mod.PRESETS["tiny"])
    for mod in (J2, J3):
        init = mod.init
        monkeypatch.setattr(mod, "init", lambda rng, _i=init, _m=mod, **kw: _i(rng, **{**_m.PRESETS["tiny"], **kw}))


@pytest.mark.parametrize("which", list(DUMPS))
def test_main_dump_matches_jax(tmp_path, monkeypatch, capsys, which):
    """``main dump`` of both packages on one .npz covering every layer and
    the same seed: the report lines are equal, the parity_input.npy files
    are byte-identical, and ``compare`` of the two dumps exits 0 at the
    tool's defaults."""
    _tiny_everywhere(monkeypatch)
    p, s, _ = _init(which)
    flat = {f"{layer}/{leaf}": np.asarray(v) for tree in (p, s) for layer, d in tree.items()
            for leaf, v in d.items()}
    np.savez(tmp_path / "w.npz", **flat)
    args = ["dump", "--weights", str(tmp_path / "w.npz"), "--input-size", "32", "--model", which, "--seed", "3"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    JP.main(args + ["--out", str(tmp_path / "jax" / "acts.npz")])
    jax_out = capsys.readouterr().out.splitlines()
    TP.main(args + ["--out", str(tmp_path / "port" / "acts.npz"), "--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == jax_out[0] == f"loaded {len(p.keys() | s.keys())} layers, skipped 0"
    assert port_out[1].replace("port", "jax") == jax_out[1]
    inputs = [(tmp_path / d / "parity_input.npy").read_bytes() for d in ("jax", "port")]
    assert inputs[0] == inputs[1]
    with pytest.raises(SystemExit) as e:
        TP.main(["compare", str(tmp_path / "port" / "acts.npz"), str(tmp_path / "jax" / "acts.npz")])
    assert e.value.code == 0


def test_main_dump_full_preset_on_cpu(tmp_path, capsys):
    """The port's ``main dump`` at full width on the CPU: a layer the model
    lacks is reported skipped, the layers the .npz lacks keep the seeded
    initialisation, a given --input is used and no input is written, and
    the dump has JAX's 2D tap names."""
    np.savez(tmp_path / "w.npz", **{"conv1/kernel": np.zeros((7, 7, 3, 96), np.float32),
                                    "not_a_layer/kernel": np.zeros(3, np.float32)})
    x = np.random.default_rng(0).normal(0, 60, (1, 32, 32, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    TP.main(["dump", "--weights", str(tmp_path / "w.npz"), "--out", str(tmp_path / "acts.npz"),
             "--input", str(tmp_path / "x.npy"), "--input-size", "32", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == "loaded 1 layers, skipped 1"
    assert not (tmp_path / "parity_input.npy").exists()
    with np.load(tmp_path / "acts.npz") as z:
        assert sorted(z.files) == sorted(JP.TAPS + ("ac_up4", "dense167classifer"))
        assert z["relu1"].shape == (1, 16, 16, 96) and z["dense167classifer"].shape == (1, 32, 32, 3)
        assert not z["relu1"].any()  # conv1's kernel came from the .npz: zeros, then BN with zero mean
