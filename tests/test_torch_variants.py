"""The last model variants of the port against the JAX package and the
NumPy Keras oracle (tests/keras_oracle.py) on CPU: the legacy
skip-connection 2D decoder (``DenseUNet2D(skip_connections=True)``), the
dilated residual 3D network (``models/dilated_resnet.py``), the dilated
``Conv`` under them and its FLOP count.

Weights come from the JAX ``init`` with randomised affines and BN
statistics (test_keras_oracle.randomize) and reach the port through the
parameter bridge; inputs are numpy draws from fixed seeds. Forwards are held
tap by tap at the goldens' bar (tests/test_goldens.py:20); one train-mode
forward and backward, with dropout 0 in both packages, at the 2D train
step's bar (tests/test_torch_train.py:47).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import keras_oracle as oracle
from hdenseunet_tpu.core.module import Ctx as JCtx
from hdenseunet_tpu.models import denseunet2d as J2, dilated_resnet as JD
from hdenseunet_tpu.train import loss as JLoss
from hdenseunet_tpu_torch.core import initializers, params as P
from hdenseunet_tpu_torch.models import denseunet2d as T2, layers as L
from hdenseunet_tpu_torch.models.dilated_resnet import DilatedResNet
from hdenseunet_tpu_torch.train import loss as TLoss
from hdenseunet_tpu_torch.utils.flops import conv_flops
from test_keras_oracle import assert_taps_close, randomize

GOLDEN_TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_goldens.py:20
STEP_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py:47
# the JAX oracle test's skip-compatible tiny 2D layout (test_keras_oracle.py:160-166):
# box channels relu1 96, concat_2 112, concat_3 72 meet decoder widths 0-2
LEGACY_2D = dict(blocks=(2, 2, 2, 2), growth=8, decoder_widths=(72, 112, 96, 16, 16))
DR_WIDTHS = (8, 16, 32, 64)
_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def legacy2d():
    params, state = J2.init(jax.random.key(0), input_size=64, batch=2, skip_connections=True, **LEGACY_2D)
    params, state = randomize(params, state, seed=7)
    x = np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    model = P.from_numpy(T2.DenseUNet2D(skip_connections=True, **LEGACY_2D), params, state)
    return model, params, state, x


@pytest.fixture(scope="module")
def dilated():
    params, state = JD.init(jax.random.key(0), input_size=32, input_cols=4, batch=2, widths=DR_WIDTHS)
    params, state = randomize(params, state, seed=9)
    x = np.random.default_rng(10).normal(0, 1, (2, 32, 32, 4, 1)).astype(np.float32)
    model = P.from_numpy(DilatedResNet(widths=DR_WIDTHS), params, state)
    return model, params, state, x


def _jax_specs(apply_fn, shape, **kwargs):
    """The JAX init's ({layer: {leaf: shape}} of params, same of state),
    from an abstract trace: no weights are materialised."""
    ctx = JCtx(record=True, train=False)
    jax.eval_shape(lambda v: apply_fn(ctx, v, **kwargs), jnp.zeros(shape, jnp.float32))
    return (
        {n: {leaf: s.shape for leaf, s in d.items()} for n, d in ctx.param_specs.items()},
        {n: {leaf: shape for leaf, (shape, _) in d.items()} for n, d in ctx.state_specs.items()},
    )


def _torch_layout(leaf, arr):
    arr = np.asarray(arr)
    return arr.transpose(_TO_TORCH[arr.ndim]) if leaf == "kernel" and arr.ndim in _TO_TORCH else arr


# --------------------------------------------------------------------------
# the dilated Conv and its FLOP count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3])
def test_dilated_conv3d_matches_lax(kernel, dilation):
    """Conv(dilation=d) with the symmetric padding (k-1)*d//2 against
    lax.conv_general_dilated(rhs_dilation=d), kernel layout through the
    bridge; a 3^3 kernel over an asymmetric input catches a permuted axis."""
    rng = np.random.default_rng(kernel * 10 + dilation)
    x = rng.normal(size=(2, 12, 10, 6, 5)).astype(np.float32)
    w = rng.normal(size=(kernel,) * 3 + (5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    pad = (kernel - 1) * dilation // 2
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), [(pad, pad)] * 3,
        rhs_dilation=(dilation,) * 3, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    ) + b
    conv = L.Conv(5, 7, kernel, ndim=3, padding=pad, dilation=dilation)
    with torch.no_grad():
        conv.kernel.copy_(P.to_torch_layout("kernel", w))
        conv.bias.copy_(torch.from_numpy(b))
        got = conv(L.channels_last(torch.from_numpy(x).movedim(-1, 1))).movedim(1, -1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GOLDEN_TOL)


@pytest.mark.parametrize("padding, size", [(2, 16), (0, 12), ("same", 16)])
def test_flop_counter_uses_the_dilated_extent(padding, size):
    """The output size comes from the dilated extent (k-1)*d+1 = 5; the
    MACs per output stay k^3 * cin."""
    conv = L.Conv(4, 6, 3, ndim=3, padding=padding, dilation=2, name="c", device="meta")
    x = torch.empty((2, 4, 16, 16, 16), device="meta")
    with L.count_flops() as counter:
        y = conv(x)
    assert tuple(y.shape) == (2, 6, size, size, size)
    assert counter.total == 2.0 * 2 * size**3 * 6 * 27 * 4


# --------------------------------------------------------------------------
# the legacy skip-connection 2D decoder
# --------------------------------------------------------------------------


def test_legacy_2d_layer_set_matches_jax_at_full_width():
    want = _jax_specs(J2.apply, (1, 64, 64, 3), skip_connections=True)
    got = P.spec(T2.DenseUNet2D(skip_connections=True, device="meta"))
    assert got == want
    assert got[0]["line0"] == {"kernel": (1, 1, 2112, 2208), "bias": (2208,)}
    # without the flag the layer set is the current model's, line0 absent
    current = P.spec(T2.DenseUNet2D(device="meta"))
    assert current == _jax_specs(J2.apply, (1, 64, 64, 3))
    assert set(got[0]) - set(current[0]) == {"line0"}


def test_legacy_2d_matches_jax_and_the_oracle(legacy2d):
    """Every tap of the JAX forward and of the Keras oracle, and line0
    against a 1x1 conv of concat_4 with line0's weights."""
    model, params, state, x = legacy2d
    taps = {}
    with torch.inference_mode():
        feat, logits = model(torch.from_numpy(x), taps=taps)
    got = {k: v.numpy() for k, v in taps.items()}
    np.testing.assert_array_equal(got["ac_up4"], feat.numpy())
    np.testing.assert_array_equal(got["dense167classifer"], logits.numpy())

    def jax_taps(p, s, v):
        jtaps = {}
        J2.apply(JCtx(p, s, train=False), v, skip_connections=True, taps=jtaps, **LEGACY_2D)
        return jtaps

    want_jax = {k: np.asarray(v) for k, v in jax.jit(jax_taps)(params, state, jnp.asarray(x)).items()}
    want_oracle = oracle.dense_unet_2d(params, state, x, blocks=LEGACY_2D["blocks"], skip_connections=True)
    assert set(want_jax) == set(want_oracle) == set(got) - {"line0"}
    for name in sorted(want_jax):
        np.testing.assert_allclose(got[name], want_jax[name], **GOLDEN_TOL, err_msg=f"jax {name}")
        np.testing.assert_allclose(got[name], want_oracle[name], **GOLDEN_TOL, err_msg=f"oracle {name}")
    line0 = np.einsum("bhwc,cd->bhwd", got["concat_4_2"], np.asarray(params["line0"]["kernel"])[0, 0])
    np.testing.assert_allclose(got["line0"], line0 + np.asarray(params["line0"]["bias"]), **GOLDEN_TOL)


def test_legacy_2d_train_step_matches_jax(legacy2d):
    """Train mode (live BN) with decoder dropout 0, the weighted CE of the
    2D stage (K2's plain version here): the loss, every parameter's
    gradient against jax.grad and every new moving statistic."""
    model, params, state, x = legacy2d
    labels = np.random.default_rng(11).integers(0, 3, x.shape[:3]).astype(np.int32)

    def jax_loss(p):
        ctx = JCtx(p, state, train=True, rng=jax.random.key(1))
        _, logits = J2.apply(ctx, jnp.asarray(x), skip_connections=True, decoder_dropout=0.0, **LEGACY_2D)
        return JLoss.weighted_crossentropy_2d(logits, jnp.asarray(labels)), ctx.new_state

    (want_loss, new_state), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    ctx = L.Ctx(0, device="cpu")
    _, logits = model(torch.from_numpy(x), ctx, decoder_dropout=0.0)
    loss = TLoss.weighted_crossentropy_2d(logits, torch.from_numpy(labels))
    model.zero_grad()
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_grads_and_stats(model, ctx, grads, new_state)


def _assert_grads_and_stats(model, ctx, grads, new_state):
    bn_names = {layer: name for name, layer in P.layers(model).items()}
    for name, layer in P.layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            np.testing.assert_allclose(
                t.grad.numpy(), _torch_layout(leaf, grads[name][leaf]), **STEP_TOL, err_msg=f"{name}/{leaf}"
            )
    assert {bn_names[bn] for bn in ctx.new_stats} == set(new_state)
    for bn, (mean, var) in ctx.new_stats.items():
        want = new_state[bn_names[bn]]
        np.testing.assert_allclose(mean.numpy(), np.asarray(want["moving_mean"]), **STEP_TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(want["moving_variance"]), **STEP_TOL)


def test_current_2d_model_is_unchanged():
    """Without the flag: no line0, no skip adds; the same bits as the
    current model built on the same weights before any flag existed."""
    kw = T2.PRESETS["tiny"]
    params, state = J2.init(jax.random.key(3), input_size=32, **kw)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 50, (1, 32, 32, 3)).astype(np.float32))
    plain = P.from_numpy(T2.DenseUNet2D(**kw), params, state)
    explicit = P.from_numpy(T2.DenseUNet2D(skip_connections=False, **kw), params, state)
    assert "line0" not in plain and list(plain) == list(explicit)
    taps = {}
    with torch.inference_mode():
        a, b = plain(x, taps=taps), explicit(x)
    assert "line0" not in taps
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# --------------------------------------------------------------------------
# the dilated residual network
# --------------------------------------------------------------------------


@pytest.mark.parametrize("widths", [DR_WIDTHS, (64, 128, 256, 512)])
def test_dilated_resnet_layer_set_matches_jax(widths):
    want = _jax_specs(JD.apply, (1, 32, 32, 4, 1), widths=widths)
    got = P.spec(DilatedResNet(widths=widths, device="meta"))
    assert got == want
    model = initializers.init_model(DilatedResNet(widths=DR_WIDTHS), seed=0)
    assert all(layer.inits["kernel"] == "normal" for layer in model.values() if isinstance(layer, L.Conv))


@pytest.mark.parametrize("reference", ["jax", "oracle"])
def test_dilated_resnet_matches_jax_and_the_oracle(dilated, reference):
    model, params, state, x = dilated
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    if reference == "jax":
        want = jax.jit(lambda p, s, v: JD.apply(JCtx(p, s, train=False), v, widths=DR_WIDTHS))(
            params, state, jnp.asarray(x)
        )
    else:
        want = oracle.dilated_resnet(params, state, x)
    assert got.shape == (2, 32, 32, 4, 2)
    np.testing.assert_allclose(got, np.asarray(want), **GOLDEN_TOL)


def test_dilated_resnet_train_step_matches_jax(dilated):
    """Train mode (live BN): the gradient of a fixed linear functional of
    the logits against jax.grad, and every new moving statistic."""
    model, params, state, x = dilated
    r = np.random.default_rng(12).normal(size=x.shape[:4] + (2,)).astype(np.float32)

    def jax_loss(p):
        ctx = JCtx(p, state, train=True, rng=jax.random.key(1))
        return jnp.mean(JD.apply(ctx, jnp.asarray(x), widths=DR_WIDTHS) * r), ctx.new_state

    (want_loss, new_state), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    ctx = L.Ctx(0, device="cpu")
    loss = (model(torch.from_numpy(x), ctx) * torch.from_numpy(r)).mean()
    model.zero_grad()
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_grads_and_stats(model, ctx, grads, new_state)


# --------------------------------------------------------------------------
# FLOPs at full width, on the meta device
# --------------------------------------------------------------------------


def test_legacy_2d_flops_at_full_width():
    """The legacy model's conv FLOPs: the current model's plus line0's 1x1
    projection of concat_4 (2112 -> 2208 channels at H/16), and the JAX
    package's count of the same graph."""
    from hdenseunet_tpu.utils.flops import conv_flops as jax_conv_flops

    shape = (2, 224, 224, 3)
    legacy = conv_flops(T2.DenseUNet2D(skip_connections=True, device="meta"), shape)
    current = conv_flops(T2.DenseUNet2D(device="meta"), shape)
    assert legacy - current == 2.0 * 2 * 14 * 14 * 2208 * 2112
    assert legacy == jax_conv_flops(J2.apply, shape, skip_connections=True)


def test_dilated_resnet_flops_at_full_width():
    """Against a hand count: 2 * B * H*W*D at each conv's scale * k^3 * cin
    * cout, scales halving H and W at each (2,2,1) pool."""
    b, h, w, d = 2, 224, 224, 8
    w0, w1, w2, w3 = 64, 128, 256, 512

    def c(scale, k, cin, cout):
        return 2.0 * b * (h // scale) * (w // scale) * d * k**3 * cin * cout

    def res(scale, cin, ch):
        return c(scale, 3, cin, ch) + c(scale, 3, ch, ch) + c(scale, 1, cin, ch)

    def dil(scale, ch):
        return 2 * c(scale, 3, ch, ch)

    hand = (
        c(1, 3, 1, w0) + res(2, w0, w1) + res(4, w1, w2) + res(8, w2, w3) + dil(8, w3)
        + res(16, w3, w3) + dil(16, w3)
        + c(8, 1, w3, w3) + res(8, w3, w3) + dil(8, w3)  # up0, res5, dil3
        + c(4, 1, w2, w3) + res(4, w3, w2)  # up1, res6
        + c(2, 1, w1, w2) + res(2, w2, w1)  # up2, res7
        + c(1, 1, w0, w1) + res(1, w1, w0)  # up3, res8
        + c(1, 1, w0, 2)  # head
    )
    assert conv_flops(DilatedResNet(device="meta"), (b, h, w, d, 1)) == hand


# --------------------------------------------------------------------------
# the parity tool at full width (weights/parity.py)
# --------------------------------------------------------------------------


def test_parity_dumps_of_both_variants_match_the_oracle_at_full_width():
    """``dump_activations(skip_connections=True)`` (every tap and line0) and
    ``dump_activations_dilated`` at the full layouts, on the CPU, against
    the Keras oracle on the same randomised weights (the port's seeded
    initialiser: the full JAX init would draw ~130 M values leaf by leaf), at the oracle tests'
    bar for the full layouts (1e-4 of each tap's largest magnitude,
    test_keras_oracle.assert_taps_close): 161 layers of 2208-channel sums
    in another order."""
    from hdenseunet_tpu_torch.weights import parity

    rng = np.random.default_rng(13)
    params, state = randomize(*P.to_numpy(initializers.init_model(T2.DenseUNet2D(skip_connections=True), 1)), seed=14)
    x = rng.normal(0, 1, (1, 32, 32, 3)).astype(np.float32)
    got = parity.dump_activations(params, state, x, skip_connections=True, device="cpu")
    want = oracle.dense_unet_2d(params, state, x, skip_connections=True)
    assert set(got) == set(want) | {"line0"}
    assert_taps_close(got, want)

    params, state = randomize(*P.to_numpy(initializers.init_model(DilatedResNet(), 2)), seed=15)
    x = rng.normal(0, 1, (1, 32, 32, 4, 1)).astype(np.float32)
    got = parity.dump_activations_dilated(params, state, x, device="cpu")
    assert_taps_close(got, {"dr_head": oracle.dilated_resnet(params, state, x)})
