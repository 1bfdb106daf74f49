"""Tiny-preset models of the port against the JAX package, and the bridge.

Weights come from the JAX ``*.init`` at the goldens' seeds and reach the port
through the parameter bridge; inputs are the goldens' numpy draws. Forwards
are held to tests/goldens/tiny_forward.npz at its own bar and to the live JAX
forward.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.module import Ctx
from hdenseunet_tpu.models import denseunet2d as J2, denseunet3d as J3, hybrid as JH
from hdenseunet_tpu_torch.core import initializers, params as P
from hdenseunet_tpu_torch.models import denseunet2d as T2, denseunet3d as T3, hybrid as TH
from hdenseunet_tpu_torch.models import layers as L

GOLDEN = Path(__file__).parent / "goldens" / "tiny_forward.npz"
# the goldens' own bar (tests/test_goldens.py): CPU/TPU and fusion order
GOLDEN_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """JAX (params, state) and inputs exactly as tests/test_goldens.py makes
    them, plus the port's models loaded from the same params."""
    rng = np.random.default_rng(1234)
    tiny2, tiny3 = J2.PRESETS["tiny"], J3.PRESETS["tiny"]
    p2, s2 = J2.init(jax.random.key(7), input_size=32, **tiny2)
    x2 = rng.normal(0, 50, (2, 32, 32, 3)).astype(np.float32)
    p3, s3 = J3.init(jax.random.key(8), input_size=32, input_cols=8, channels=4, **tiny3)
    x3 = rng.normal(0, 50, (1, 32, 32, 8, 4)).astype(np.float32)
    ph, sh = JH.init(jax.random.key(9), input_size=32, input_cols=8, batch=1, preset="tiny")
    xv = rng.normal(0, 50, (1, 32, 32, 8, 1)).astype(np.float32)
    return {
        "2d": (P.from_numpy(T2.DenseUNet2D(**T2.PRESETS["tiny"]), p2, s2), (p2, s2), x2),
        "3d": (P.from_numpy(T3.DenseUNet3D(**T3.PRESETS["tiny"]), p3, s3), (p3, s3), x3),
        "hybrid": (P.from_numpy(TH.HDenseUNet(preset="tiny"), ph, sh), (ph, sh), xv),
    }


def _port_outputs(models):
    with torch.inference_mode():
        m2, _, x2 = models["2d"]
        feat2, logits2 = m2(torch.from_numpy(x2))
        m3, _, x3 = models["3d"]
        _, logits3 = m3(torch.from_numpy(x3))
        mh, _, xv = models["hybrid"]
        hyb = mh(torch.from_numpy(xv), arch="end2end")
    return {
        "d2_logits": logits2.numpy(),
        "d2_feat_sum": feat2.sum(dim=(1, 2)).numpy(),
        "d3_logits": logits3.numpy(),
        "hybrid_logits": hyb.numpy(),
    }


@pytest.mark.parametrize("key", ["d2_logits", "d2_feat_sum", "d3_logits", "hybrid_logits"])
def test_tiny_forward_matches_goldens(models, key):
    got = _port_outputs(models)[key]
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(got, z[key], **GOLDEN_TOL)


@pytest.mark.parametrize("which", ["2d", "3d", "hybrid"])
def test_tiny_forward_matches_live_jax(models, which):
    model, (p, s), x = models[which]
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    if which == "hybrid":
        want = jax.jit(lambda v: JH.apply(Ctx(p, s, train=False), v, preset="tiny"))
        pairs = [(got, want(jnp.asarray(x)))]
    else:  # (features, logits)
        ref = J2 if which == "2d" else J3
        want = jax.jit(lambda v: ref.apply(Ctx(p, s, train=False), v, **ref.PRESETS["tiny"]))
        pairs = zip(got, want(jnp.asarray(x)))
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GOLDEN_TOL)


def test_hybrid_archs_differ_only_in_inference_dropout(models):
    model, _, xv = models["hybrid"]
    with torch.inference_mode():
        a = model(torch.from_numpy(xv), arch="end2end")
        b = model(torch.from_numpy(xv), arch="3dpart")
    assert torch.equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 8])
def test_stack_and_unstack_match_jax(depth):
    vol = np.random.default_rng(depth).normal(size=(2, 4, 3, depth, 1)).astype(np.float32)
    stacks = TH.stack_adjacent_slices(torch.from_numpy(vol))
    np.testing.assert_array_equal(stacks.numpy(), np.asarray(JH.stack_adjacent_slices(jnp.asarray(vol))))
    y = np.random.default_rng(0).normal(size=(2 * depth, 4, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        TH.unstack_to_volume(torch.from_numpy(y), 2, depth).numpy(),
        np.asarray(JH.unstack_to_volume(jnp.asarray(y), 2, depth)),
    )


def test_full_preset_bridge_is_a_bijection():
    """Every full-preset layer, leaf and shape of the JAX abstract trace has
    exactly one counterpart in the port; no weights are materialised."""
    ctx = Ctx(record=True, train=False)
    jax.eval_shape(
        lambda v: JH.apply(ctx, v, preset="full"), jnp.zeros((1, 32, 32, 8, 1), jnp.float32)
    )
    want_p = {n: {l: s.shape for l, s in d.items()} for n, d in ctx.param_specs.items()}
    want_s = {n: {l: shape for l, (shape, _) in d.items()} for n, d in ctx.state_specs.items()}
    got_p, got_s = P.spec(TH.HDenseUNet(preset="full", device="meta"))
    assert got_p == want_p
    assert got_s == want_s
    assert len(got_p) == 683 and len(got_s) == 231


# JAX kernel layout -> the port's: HWIO -> OIHW; (kh,kw,kd,I,O) -> (O,I,kh,kw,kd)
_KERNEL_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def test_bridge_round_trip_is_exact(models):
    """Every leaf of the JAX pytree lands in the port exactly once, bit for
    bit, in the port's layout; the port holds no other leaf."""
    model, (p, s), _ = models["hybrid"]
    layers = P.layers(model)
    assert layers.keys() == p.keys() | s.keys()
    for name, layer in layers.items():
        got = P.leaves(layer)
        assert got.keys() == p.get(name, {}).keys() | s.get(name, {}).keys(), name
        for leaf, t in got.items():
            want = np.asarray(p[name][leaf] if leaf in p.get(name, {}) else s[name][leaf])
            if leaf == "kernel":
                want = want.transpose(_KERNEL_TO_TORCH[want.ndim])
            np.testing.assert_array_equal(t.detach().numpy(), want, err_msg=f"{name}/{leaf}")


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_bridge_rejects_a_mismatched_pytree(models, fault):
    _, (p, s), _ = models["hybrid"]
    p = {n: dict(d) for n, d in p.items()}
    if fault == "missing":
        del p["conv1"]["kernel"]
    elif fault == "unexpected":
        p["conv1"]["extra"] = np.zeros(3, np.float32)
    else:
        p["3dconv1"]["kernel"] = np.zeros((7, 7, 7, 96, 4), np.float32)  # I/O swapped
    with pytest.raises(ValueError, match="does not match"):
        P.from_numpy(TH.HDenseUNet(preset="tiny"), p, s)


def test_seeded_init_follows_the_jax_distributions():
    model = initializers.init_model(TH.HDenseUNet(preset="tiny"), seed=3)
    again = initializers.init_model(TH.HDenseUNet(preset="tiny"), seed=3)
    for name, layer in P.layers(model).items():
        for leaf, t in P.leaves(layer).items():
            t = t.detach()
            assert torch.equal(t, P.leaves(P.layers(again)[name])[leaf]), (name, leaf)
            kind = layer.inits[leaf]
            if kind == "ones":
                assert bool((t == 1).all())
            elif kind == "zeros":
                assert bool((t == 0).all())
            elif kind == "glorot_uniform":
                fan_in, fan_out = initializers._fans(t.shape)
                limit = (6.0 / (fan_in + fan_out)) ** 0.5
                assert float(t.abs().max()) <= limit
                if t.numel() > 2000:  # sample std of U(-l, l) is l/sqrt(3)
                    assert abs(float(t.std()) - limit / 3**0.5) < 0.1 * limit
            else:
                assert kind == "normal" and isinstance(layer, L.Conv)
                if t.numel() > 2000:
                    assert abs(float(t.std()) - 0.05) < 0.005
