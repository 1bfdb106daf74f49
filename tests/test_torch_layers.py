"""Every layer op of the port against its JAX twin (models/layers.py), fp32 on CPU.

Inputs and weights are numpy draws from fixed seeds; JAX gets them as its
pytree, the port through the parameter bridge. 3D convs use 3^3 and 7^3
kernels on non-cubic volumes, so a wrong kernel permutation cannot pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hdenseunet_tpu.core.module import Ctx
from hdenseunet_tpu.models import layers as JL
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.models import layers as L

# float32 sums in another order (oneDNN against XLA): a few fp32 ulps of the
# accumulated magnitude
CONV_TOL = dict(rtol=2e-5, atol=2e-5)
# elementwise float32 chains that may or may not be contracted into FMAs
EW_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _to_torch(x_jax_layout):
    """(N, *S, C) numpy -> PyTorch (N, C, *S) tensor in channels-last memory."""
    return torch.from_numpy(np.ascontiguousarray(x_jax_layout)).movedim(-1, 1)


def _to_jax_layout(t):
    return t.movedim(1, -1).numpy()


def _load(name, layer, params, state=None):
    return from_numpy(nn.ModuleDict({name: layer}), params, state or {})[name]


@pytest.mark.parametrize("size", range(1, 12))
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (7, 2), (2, 2)])
def test_padding_rules_match_jax(size, kernel, stride):
    assert L.same_pads(size, kernel, stride) == JL._same_pads(size, kernel, stride)
    for padding in ("same", "valid", 3, (1, 2)):
        assert L.conv_padding((size, size + 1), (kernel, kernel), (stride, stride), padding) == (
            JL._conv_padding((size, size + 1), (kernel, kernel), (stride, stride), padding)
        )


CONV_CASES = [
    # (spatial, cin, features, kernel, stride, padding, use_bias)
    ((16, 12), 5, 7, 1, 1, "valid", False),
    ((16, 12), 5, 7, 3, 1, 1, False),
    ((32, 24), 3, 8, 7, 2, 3, False),  # 2D stem
    ((16, 12), 5, 7, 3, 1, "same", True),
    ((16, 15), 5, 7, 3, 2, "same", True),  # TF split: (0, 1) on H, (1, 1) on W
    ((16, 12, 8), 4, 6, 1, 1, "valid", False),
    ((16, 12, 8), 4, 6, 3, 1, 1, False),
    ((16, 12, 8), 4, 6, 7, 2, 3, False),  # 3D stem, 7^3 stride 2
    ((16, 12, 8), 4, 6, 3, 1, "same", True),
    ((16, 12, 7), 4, 6, 3, 2, "same", True),  # asymmetric TF split on H, W
]


@pytest.mark.parametrize("spatial,cin,features,kernel,stride,padding,use_bias", CONV_CASES)
def test_conv_matches_jax(spatial, cin, features, kernel, stride, padding, use_bias):
    nd = len(spatial)
    rng = np.random.default_rng(len(spatial) * 100 + kernel * 10 + stride)
    x = rng.normal(size=(2,) + spatial + (cin,)).astype(np.float32)
    leaves = {"kernel": rng.normal(0, 0.2, (kernel,) * nd + (cin, features)).astype(np.float32)}
    if use_bias:
        leaves["bias"] = rng.normal(size=features).astype(np.float32)
    want = JL.conv(
        Ctx({"c": leaves}, {}), jnp.asarray(x), "c", features, kernel,
        stride=stride, padding=padding, use_bias=use_bias,
    )
    layer = _load(
        "c",
        L.Conv(cin, features, kernel, ndim=nd, stride=stride, padding=padding, use_bias=use_bias),
        {"c": leaves},
    )
    with torch.no_grad():
        got = layer(L.channels_last(_to_torch(x)))
    assert got.is_contiguous(memory_format=torch.channels_last if nd == 2 else torch.channels_last_3d)
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), **CONV_TOL)


def _bn_leaves(rng, c):
    return (
        {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)},
        {
            "moving_mean": rng.normal(size=c).astype(np.float32),
            "moving_variance": rng.uniform(0.2, 2.0, c).astype(np.float32),
        },
    )


@pytest.mark.parametrize("eps", [1e-3, 1.1e-5])
@pytest.mark.parametrize("shape", [(2, 8, 6, 12), (2, 8, 6, 4, 12)])
def test_frozen_batch_norm_matches_jax(shape, eps):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    p, s = _bn_leaves(rng, shape[-1])
    want = JL.batch_norm(Ctx({"bn": p}, {"bn": s}, train=False), jnp.asarray(x), "bn", eps=eps)
    layer = _load("bn", L.BatchNorm(shape[-1], eps=eps), {"bn": p}, {"bn": s})
    with torch.no_grad():
        got = layer(_to_torch(x))
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), **EW_TOL)


@pytest.mark.parametrize("relu_after", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 6, 36), (2, 8, 6, 4, 96)])
def test_bn_scale_relu_matches_jax(shape, relu_after):
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    p, s = _bn_leaves(rng, c)
    sc = {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)}
    ctx = Ctx({"bn": p, "sc": sc}, {"bn": s}, train=False)
    want = JL.bn_scale_relu(ctx, jnp.asarray(x), "bn", "sc", eps=1.1e-5, relu_after=relu_after)
    md = from_numpy(
        nn.ModuleDict({"bn": L.BatchNorm(c, eps=1.1e-5), "sc": L.Scale(c)}),
        {"bn": p, "sc": sc}, {"bn": s},
    )
    with torch.no_grad():
        got = L.bn_scale_relu(_to_torch(x), md["bn"], md["sc"], relu_after=relu_after)
    # folded affine: the products reassociate, a few fp32 ulps of |x*A|
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_frozen_bn_scale_relu_equals_folding_per_call():
    rng = np.random.default_rng(8)
    c = 24
    p, s = _bn_leaves(rng, c)
    sc = {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)}
    md = from_numpy(
        nn.ModuleDict({"x_bn": L.BatchNorm(c, eps=1.1e-5), "x_scale": L.Scale(c)}),
        {"x_bn": p, "x_scale": sc}, {"x_bn": s},
    )
    x = _to_torch(rng.normal(size=(2, 8, 6, c)).astype(np.float32))
    with torch.no_grad():
        per_call = L.bn_scale_relu(x, md["x_bn"], md["x_scale"])
        L.freeze_bn_scale(md)
        assert md["x_scale"].folded is not None
        frozen = L.bn_scale_relu(x, md["x_bn"], md["x_scale"])
    assert torch.equal(frozen, per_call)


def test_freeze_pairs_every_scale_of_the_full_model():
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    model = L.freeze_bn_scale(HDenseUNet(preset="full", device="meta"))
    scales = [m for m in model.modules() if isinstance(m, L.Scale)]
    assert len(scales) == 220  # 161 bn_scale_relu per 2D forward + 59 per 3D
    for sc in scales:
        a, b = sc.folded
        assert a.shape == b.shape == sc.gamma.shape and a.dtype == torch.float32


def test_scale_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 3, 9)).astype(np.float32)
    sc = {"gamma": rng.normal(size=9).astype(np.float32), "beta": rng.normal(size=9).astype(np.float32)}
    want = JL.scale(Ctx({"sc": sc}, {}), jnp.asarray(x), "sc")
    layer = _load("sc", L.Scale(9), {"sc": sc})
    with torch.no_grad():
        got = layer(_to_torch(x))
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), **EW_TOL)


@pytest.mark.parametrize(
    "shape,window,stride,pad",
    [
        ((2, 16, 12, 5), 3, 2, 1),
        ((2, 15, 12, 5), 3, 2, 1),
        ((2, 16, 12, 5), 2, 2, 0),
        ((2, 16, 12, 8, 5), 3, 2, 1),
        ((2, 16, 12, 7, 5), 3, 2, 1),
    ],
)
def test_max_pool_pads_with_zeros_like_jax(shape, window, stride, pad):
    # all-negative input: zero padding differs from -inf padding at every border
    x = -np.abs(np.random.default_rng(8).normal(size=shape)).astype(np.float32) - 0.1
    want = JL.max_pool(jnp.asarray(x), window, stride, pad=pad)
    got = L.max_pool(_to_torch(x), window, stride, pad=pad)
    np.testing.assert_array_equal(_to_jax_layout(got), np.asarray(want))
    if pad:
        assert (_to_jax_layout(got) == 0).any()


@pytest.mark.parametrize(
    "shape,window",
    [((2, 16, 12, 5), 2), ((2, 16, 12, 8, 5), (2, 2, 1)), ((2, 16, 12, 8, 5), 2)],
)
def test_avg_pool_matches_jax(shape, window):
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    want = JL.avg_pool(jnp.asarray(x), window, window)
    got = L.avg_pool(_to_torch(x), window, window)
    assert got.is_contiguous(memory_format=torch.channels_last if len(shape) == 4 else torch.channels_last_3d)
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), **EW_TOL)


@pytest.mark.parametrize(
    "shape,factors",
    [((2, 4, 3, 5), 2), ((2, 4, 3, 5, 5), (2, 2, 1)), ((2, 4, 3, 2, 5), (2, 2, 2)), ((1, 2, 3, 4, 2), (1, 3, 2))],
)
def test_upsample_nearest_matches_jax(shape, factors):
    x = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    want = JL.upsample_nearest(jnp.asarray(x), factors)
    got = L.upsample_nearest(_to_torch(x), factors)
    assert got.is_contiguous(memory_format=torch.channels_last if len(shape) == 4 else torch.channels_last_3d)
    np.testing.assert_array_equal(_to_jax_layout(got), np.asarray(want))


def test_inference_dropout_is_identity():
    x = torch.tensor([-1.0, 0.0, 2.0])
    assert L.dropout(x, 0.3) is x
