"""Warm-start weights of the port (hdenseunet_tpu_torch.weights.convert and
core.params.to_numpy) against the JAX package on CPU: the by-name merge
reports the same layers and lands the same parameters, the .npz reader
reads the same arrays, and the parameter bridge is its own inverse.

The weights are seeded numpy draws in the layers, leaves and shapes of the
JAX package's own abstract trace of each tiny model (``Ctx(record=True)``
under ``jax.eval_shape``), which costs a fraction of a JAX ``init``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hdenseunet_tpu.core.module import Ctx as JCtx
from hdenseunet_tpu.models import denseunet2d as J2, hybrid as JH
from hdenseunet_tpu.weights import convert as j_convert
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.train import trainer as T
from hdenseunet_tpu_torch.train.checkpoint import Checkpointer
from hdenseunet_tpu_torch.weights import convert as t_convert

SIZE, COLS = 32, 8


def jax_trees(arch, seed):
    """(params, state) of the JAX package's tiny model for arch, as seeded
    numpy draws in the shapes of its abstract trace."""
    ctx = JCtx(record=True, train=False)
    if arch == "2d":
        x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
        jax.eval_shape(lambda v: J2.apply(ctx, v, **J2.PRESETS["tiny"]), x)
    else:
        x = jnp.zeros((1, SIZE, SIZE, COLS, 1), jnp.float32)
        jax.eval_shape(lambda v: JH.apply(ctx, v, preset="tiny"), x)
    rng = np.random.default_rng(seed)
    draw = lambda shape: rng.normal(0, 1, shape).astype(np.float32)
    params = {n: {l: draw(s.shape) for l, s in d.items()} for n, d in ctx.param_specs.items()}
    state = {n: {l: np.abs(draw(shape)) for l, (shape, _) in d.items()} for n, d in ctx.state_specs.items()}
    return params, state


@pytest.fixture(scope="module")
def inits():
    return {"2d": jax_trees("2d", 1), "hybrid": jax_trees("end2end", 2)}


def _cfg():
    cfg = Config()
    cfg.model.preset, cfg.model.input_size = "tiny", SIZE
    return cfg


def _model(arch, params, state):
    return P.from_numpy(T.build_model(_cfg(), arch), params, state)


def _np(tree):
    return {n: {l: np.asarray(a) for l, a in d.items()} for n, d in tree.items()}


def _merged(params, state):
    raw = {}
    for tree in (params, state):
        for n, d in _np(tree).items():
            raw.setdefault(n, {}).update(d)
    return raw


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].keys() == want[n].keys(), n
        for leaf in want[n]:
            g, w = got[n][leaf], np.asarray(want[n][leaf])
            assert g.dtype == np.float32 and g.shape == w.shape and np.array_equal(g, w), (n, leaf)


@pytest.mark.parametrize("arch", ["2d", "end2end"])
def test_to_numpy_inverts_from_numpy(inits, arch):
    params, state = inits["2d" if arch == "2d" else "hybrid"]
    model = _model(arch, params, state)
    got_p, got_s = P.to_numpy(model)
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, state)
    got_p["conv1"]["kernel"][...] = 0  # copies, not views of the model
    assert float(P.layers(model)["conv1"].kernel.detach().abs().sum()) > 0


def test_warm_start_of_the_hybrid_from_a_2d_stage_matches_jax(inits):
    """A tiny 2D-stage npz into a tiny hybrid: the same report as the JAX
    match_to_model, and the same parameters through the bridge."""
    raw = _merged(*inits["2d"])
    hp, hs = inits["hybrid"]
    want_p, want_s, want_report = j_convert.match_to_model(raw, hp, hs, strict_shapes=False)
    model = _model("end2end", hp, hs)
    L.freeze_bn_scale(model)  # a serving fold of the old weights
    report = t_convert.match_to_model(raw, model, strict_shapes=False)
    assert report == want_report
    assert len(report["loaded"]) == len(raw) and not report["skipped"] and not report["mismatched"]
    got_p, got_s = P.to_numpy(model)
    _assert_trees_equal(got_p, want_p)
    _assert_trees_equal(got_s, want_s)
    assert all(m.folded is None for m in model.modules() if isinstance(m, L.Scale))


def test_skipped_and_mismatched_layers_reported_as_jax_does(inits):
    raw = _merged(*inits["2d"])
    raw["not_a_layer"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    raw["conv1"] = dict(raw["conv1"], kernel=np.zeros((3, 3, 3, 4), np.float32))
    hp, hs = inits["hybrid"]
    model = _model("end2end", hp, hs)
    with pytest.raises(ValueError) as got:
        t_convert.match_to_model(raw, model, strict_shapes=True)
    with pytest.raises(ValueError) as want:
        j_convert.match_to_model(raw, hp, hs, strict_shapes=True)
    assert str(got.value) == str(want.value)
    _assert_trees_equal(P.to_numpy(model)[0], hp)  # a strict refusal changes nothing
    _, _, want_report = j_convert.match_to_model(raw, hp, hs, strict_shapes=False)
    report = t_convert.match_to_model(raw, model, strict_shapes=False)
    # conv1's one leaf did not fit, so conv1 counts as skipped, as in JAX
    assert report == want_report and report["skipped"] == ["conv1", "not_a_layer"]
    assert report["mismatched"] == ["conv1/kernel: (3, 3, 3, 4) -> (7, 7, 3, 96)"]


def test_npz_and_checkpoint_directory_weights(inits, tmp_path):
    params, state = inits["2d"]
    flat = {f"{n}/{l}": a for n, d in _merged(params, state).items() for l, a in d.items()}
    np.savez(tmp_path / "w.npz", **flat)
    got, want = t_convert.load_npz_checkpoint(tmp_path / "w.npz"), j_convert.load_npz_checkpoint(tmp_path / "w.npz")
    _assert_trees_equal(got, want)
    assert t_convert.load_init_weights(tmp_path / "w.npz").keys() == got.keys()
    cfg = _cfg()
    st = T.create_train_state(cfg, "2d", device="cpu")
    P.from_numpy(st.model, params, state)
    Checkpointer(tmp_path / "ck").save(3, st, metric=0.5)
    _assert_trees_equal(t_convert.load_init_weights(tmp_path / "ck"), _merged(params, state))
    _assert_trees_equal(t_convert.load_checkpoint_weights(tmp_path / "ck", best=True), _merged(params, state))
    with pytest.raises(FileNotFoundError):
        t_convert.load_checkpoint_weights(tmp_path / "nothing_here")
    with pytest.raises(SystemExit):
        t_convert.load_init_weights(tmp_path / "w.h5")
