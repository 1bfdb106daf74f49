"""K5 (ops/affine_gemm.py): the dense blocks' 1x1 convolution with its
BN∘Scale∘ReLU prologue and epilogue, and the block-buffer route that calls
it at inference (models/layers.dense_block), on the CPU against the unfused
chain and against the JAX package.

- The plain K5 equals the chain the models ran before it (K1's plain
  version, the Conv module, K1's plain version) bit for bit, in float32 and
  bfloat16, with the input a channel prefix of a wider buffer, and matches
  the JAX package's bn_scale_relu -> conv -> bn_scale_relu (its XLA default
  and its Pallas kernel in interpret mode) within 2e-4 in float32.
- The block-buffer route equals the concatenation route bit for bit: the
  tiny 2D and 3D models in every 3D form, and the first layers and the
  transition of every stage at full width.
- The tiny served labelmap through K5 stays byte-identical to the JAX
  package's.

The card tests take the ``cuda`` fixture and skip without a card; they hold
the kernel to a float64 product of its own operand at each shape class and
at the edges of its tiles (M under one tile, fewer tiles than SMs, N tiles
past N), check that a buffer's channels past K are never read, that two
calls give the same bytes, and that misaligned operands and inputs that
require grad under grad mode are refused:

    python -m pytest --noconftest -q tests/test_torch_affine_gemm.py -k cuda
"""
import numpy as np
import pytest
import torch
from torch import nn

from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.core.params import from_numpy
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.models.denseunet2d import PRESETS as PRESETS_2D, DenseUNet2D
from hdenseunet_tpu_torch.models.denseunet3d import PRESETS as PRESETS_3D, DenseUNet3D
from hdenseunet_tpu_torch.ops import affine_gemm as K5

EPS = 1.1e-5  # the encoder's BatchNorm epsilon
# float32 against XLA: the 1x1 product sums K terms in another order and the
# folded affines reassociate, a few float32 ulps of the accumulated magnitude
# (the goldens' bar, tests/test_goldens.py:20)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
# (K, N, row stride, spatial with batch first, epilogue): every K and N of
# the served shape classes in small; M = 70 and 42 are not multiples of 64
CASES = [
    (96, 192, 96, (2, 5, 7), True),  # 2D stage 2's first bottleneck
    (104, 32, 104, (1, 9, 8), True),  # a tiny K
    (248, 128, 264, (2, 3, 7), True),  # 3D stage 5's first, K mod 16 = 8, a prefix
    (2160, 192, 2208, (1, 6, 7), True),  # 2D stage 5's last, a prefix
    (472, 128, 504, (2, 3, 3, 2), True),  # 3D stage 5's last, 1x1x1
    (192, 96, 192, (2, 4, 3, 2), False),  # 3D stage 2's transition
    (224, 112, 224, (1, 4, 4, 3), False),  # 3D stage 3's transition
    (496, 248, 496, (2, 3, 2, 2), False),  # 3D stage 4's transition
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaves(rng, k, n, ndim):
    """JAX-layout leaves of a 1x1 conv 'c' between two frozen BN∘Scale
    pairs, 'c' (k channels) and 'e' (n channels), with live statistics."""
    def pair(c):
        bn = dict(gamma=rng.normal(1, 0.3, c), beta=rng.normal(0, 0.5, c))
        stats = dict(moving_mean=rng.normal(0, 0.5, c), moving_variance=rng.uniform(0.5, 2, c))
        sc = dict(gamma=rng.normal(1, 0.3, c), beta=rng.normal(0, 0.5, c))
        return bn, stats, sc

    params, state = {}, {}
    for name, c in (("c", k), ("e", n)):
        params[f"{name}_bn"], state[f"{name}_bn"], params[f"{name}_scale"] = pair(c)
    params["c"] = dict(kernel=rng.normal(0, k**-0.5, (1,) * ndim + (k, n)))
    cast = lambda tree: {a: {b: np.asarray(v, np.float32) for b, v in d.items()} for a, d in tree.items()}  # noqa: E731
    return cast(params), cast(state)


def _layers(params, state, k, n, ndim):
    md = nn.ModuleDict({
        "c_bn": L.BatchNorm(k, eps=EPS), "c_scale": L.Scale(k),
        "c": L.Conv(k, n, 1, ndim=ndim, padding="valid", use_bias=False, name="c"),
        "e_bn": L.BatchNorm(n, eps=EPS), "e_scale": L.Scale(n),
    })
    return from_numpy(md, params, state)


def _case(k, n, ld, spatial, dtype, seed=0):
    """(layers, buffer (B, ld, *S) channels-last, its first k channels)."""
    rng = np.random.default_rng(seed + k + n)
    ndim = len(spatial) - 1
    params, state = _leaves(rng, k, n, ndim)
    md = _layers(params, state, k, n, ndim)
    buf = rng.normal(0, 2, (spatial[0], *spatial[1:], ld)).astype(np.float32)
    buf = torch.from_numpy(buf).to(dtype).movedim(-1, 1)
    return md, buf, buf[:, :k], (params, state)


def _chain(md, x, epilogue):
    """The route the models ran before K5: K1, the Conv module, K1."""
    y = md["c"](L.bn_scale_relu(L.channels_last(x), md["c_bn"], md["c_scale"]))
    return L.bn_scale_relu(y, md["e_bn"], md["e_scale"]) if epilogue else y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,ld,spatial,epilogue", CASES)
def test_plain_k5_equals_the_unfused_chain(k, n, ld, spatial, epilogue, dtype):
    md, buf, x, _ = _case(k, n, ld, spatial, dtype)
    assert K5.row_stride(x) == ld
    with torch.no_grad():
        want = _chain(md, x, epilogue)
        got = L.bsr_conv1x1(md, x, "c", then="e" if epilogue else None)
    assert got.shape == want.shape == (spatial[0], n, *spatial[1:]) and got.dtype == dtype
    assert got.movedim(1, -1).is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["xla", "interpret"])
@pytest.mark.parametrize("k,n,ld,spatial,epilogue", CASES[:3] + CASES[4:6])
def test_plain_k5_matches_jax(k, n, ld, spatial, epilogue, route):
    import jax.numpy as jnp

    from hdenseunet_tpu.core.module import Ctx
    from hdenseunet_tpu.models import layers as JL
    from hdenseunet_tpu.ops import fused_affine as JF

    md, buf, x, (params, state) = _case(k, n, ld, spatial, torch.float32)
    ctx = Ctx(params, state, train=False)
    xj = jnp.asarray(x.movedim(1, -1).contiguous().numpy())

    def bsr(v, name):
        if route == "xla":
            return JL.bn_scale_relu(ctx, v, f"{name}_bn", f"{name}_scale", eps=EPS)
        p, s, sc = params[f"{name}_bn"], state[f"{name}_bn"], params[f"{name}_scale"]
        a, b = JF.fold_bn_scale(p["gamma"], p["beta"], s["moving_mean"], s["moving_variance"],
                                sc["gamma"], sc["beta"], EPS)
        return JF.affine_relu(v, a, b, interpret=True)

    conv = JL.conv2d if len(spatial) == 3 else JL.conv3d
    want = conv(ctx, bsr(xj, "c"), "c", n, 1, padding="valid", use_bias=False)
    if epilogue:
        want = bsr(want, "e")
    with torch.no_grad():
        got = K5.affine_gemm(x, md["c"].kernel.reshape(n, k), *L.folded_pair(md["c_bn"], md["c_scale"]),
                             *(L.folded_pair(md["e_bn"], md["e_scale"]) if epilogue else ()))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), np.asarray(want), **JAX_TOL)


def test_row_stride():
    buf = torch.zeros(2, 24, 3, 5).to(memory_format=torch.channels_last)
    assert K5.row_stride(buf) == 24 and K5.row_stride(buf[:, :16]) == 24
    assert K5.row_stride(buf[:, 8:]) == 24  # a later channel window is rows too
    assert K5.row_stride(torch.zeros(2, 24, 3, 5)) is None  # channels-first
    assert K5.row_stride(buf[:, :, 1:]) is None  # a cropped spatial axis: no one stride
    b3 = torch.zeros(1, 16, 1, 4, 1).to(memory_format=torch.channels_last_3d)
    assert K5.row_stride(b3[:, :8]) == 16  # size-1 axes take any stride
    assert K5.row_stride(torch.zeros(1, 8, 1, 1)) == 8


def _randomize_bn(model, seed):
    """Moving statistics and BN/Scale affines away from their identity
    initialisers, so that the folded pairs are no plain ReLU."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (L.BatchNorm, L.Scale)):
                c = m.gamma.shape[0]
                m.gamma.copy_(1 + 0.3 * torch.randn(c, generator=g))
                m.beta.copy_(0.5 * torch.randn(c, generator=g))
            if isinstance(m, L.BatchNorm):
                m.moving_mean.copy_(0.5 * torch.randn(c, generator=g))
                m.moving_variance.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return model


def _both_routes(monkeypatch, forward):
    """forward() through the block-buffer route and through the
    concatenation route (``fused_1x1`` patched off), each with its taps."""
    outs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(L, "fused_1x1", lambda ctx: False)
        taps = {}
        with torch.no_grad():
            outs.append((forward(taps), taps))
    return outs


def _assert_same(a, b):
    (out_a, taps_a), (out_b, taps_b) = a, b
    assert all(torch.equal(u, v) for u, v in zip(out_a, out_b))
    assert taps_a.keys() == taps_b.keys() and taps_a
    for name in taps_a:
        assert torch.equal(taps_a[name], taps_b[name]), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_buffer_equals_cat_route_2d(monkeypatch, dtype):
    model = _randomize_bn(init_model(DenseUNet2D(**PRESETS_2D["tiny"]), 1), 2).to(dtype)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 50, (2, 64, 64, 3)).astype(np.float32))
    calls = []
    real = K5.affine_gemm
    monkeypatch.setattr(K5, "affine_gemm", lambda *a: calls.append(a[0].shape) or real(*a))
    fused, cat = _both_routes(monkeypatch, lambda taps: model(x.to(dtype), taps=taps))
    assert len(calls) == sum(PRESETS_2D["tiny"]["blocks"]) + 3  # every bottleneck, 3 transitions
    _assert_same(fused, cat)


FORMS_3D = {
    "hwdc": {}, "hwdc_s2d": dict(stem_s2d=True), "dhwc": dict(layout="dhwc"),
    "dhwc_s2d": dict(layout="dhwc", stem_s2d=True), "fold_z": dict(fold_z=True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", list(FORMS_3D))
def test_block_buffer_equals_cat_route_3d(monkeypatch, form, dtype):
    model = _randomize_bn(init_model(DenseUNet3D(**PRESETS_3D["tiny"]), 4), 5).to(dtype)
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 5, (2, 32, 32, 8, 4)).astype(np.float32))
    fused, cat = _both_routes(
        monkeypatch, lambda taps: model(x.to(dtype), taps=taps, **FORMS_3D[form]))
    _assert_same(fused, cat)


@pytest.fixture(scope="module")
def full_models():
    torch.manual_seed(0)
    return {
        "2d": _randomize_bn(init_model(DenseUNet2D(), 7), 8),
        "3d": _randomize_bn(init_model(DenseUNet3D(), 9), 10),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["2d", "3d"])
def test_block_buffer_equals_cat_route_full_width(full_models, branch, dtype):
    """At full width, each stage's first two dense layers through the block
    buffer against the concatenation route, and the stage's transition
    (its K5 launch over the whole block) against K1 and the conv."""
    model = full_models[branch]
    rng = np.random.default_rng(11)
    prefix, spatial = ("conv", (1, 5, 6)) if branch == "2d" else ("3dconv", (1, 3, 4, 2))
    conv3x3 = (lambda conv, h: conv(h))
    c0 = 96
    for stage, nb in enumerate(model.blocks, start=2):
        x = torch.from_numpy(rng.normal(0, 2, (*spatial, c0)).astype(np.float32)).to(dtype).movedim(-1, 1)
        with torch.no_grad():
            got = L.dense_block(model, x, f"{prefix}{stage}", 2, conv3x3)
            want = x
            for b in (1, 2):
                if branch == "2d":
                    new = model._conv_block(None, want, f"{prefix}{stage}_{b}", False, 0.0)
                else:
                    from hdenseunet_tpu_torch.models.denseunet3d import ops_for

                    new = model._conv_block(ops_for(), None, want, f"{prefix}{stage}_{b}", False, 0.0)
                want = L.channels_last(torch.cat([want, new], dim=1))
        assert torch.equal(got, want), (branch, stage)
        width = c0 + nb * model[f"{prefix}{stage}_1_x2"].kernel.shape[0]
        if stage - 2 < len(model.blocks) - 1:
            blk = f"{prefix}{stage}_blk"
            xb = torch.from_numpy(rng.normal(0, 2, (*spatial, width)).astype(np.float32)).to(dtype).movedim(-1, 1)
            with torch.no_grad():
                got = L.bsr_conv1x1(model, xb, blk)
                want = model[blk](L.bn_scale_relu(xb, model[blk + "_bn"], model[blk + "_scale"]))
            assert torch.equal(got, want), (branch, blk)
            c0 = model[blk].kernel.shape[0]


def test_tiny_served_labelmap_through_k5_matches_jax(monkeypatch):
    """The dedup-2D scorer's labelmask through the block-buffer route (K5's
    plain version), byte for byte the JAX package's, at thresholds taken
    from JAX's own probabilities with none of them within PROB_TOL."""
    import jax

    from hdenseunet_tpu.core.config import InferConfig as JInferConfig
    from hdenseunet_tpu.infer import device_pipeline as JD
    from hdenseunet_tpu.models import hybrid as JH
    from hdenseunet_tpu_torch.core.config import InferConfig
    from hdenseunet_tpu_torch.infer import device_pipeline as TD
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
    from test_torch_infer import _near_threshold, _thresholds, _volume

    params, state = JH.init(jax.random.key(0), input_size=32, input_cols=8, batch=1, preset="tiny")
    shape, lo, hi = (48, 40, 20), 2, 17
    vol = _volume(shape, 3)
    probs = np.asarray(JD.DeviceVolumeScorer(params, state, JInferConfig(), preset="tiny").score(vol, lo, hi))
    thresholds = _thresholds(probs)
    assert _near_threshold(probs, thresholds) == 0
    jcfg = JInferConfig(thres_liver=thresholds[0], thres_tumor=thresholds[1])
    want = JD.DeviceVolumeScorer(params, state, jcfg, preset="tiny").labelmask(vol, lo, hi)
    calls = []
    real = K5.affine_gemm
    monkeypatch.setattr(K5, "affine_gemm", lambda *a: calls.append(1) or real(*a))
    pcfg = InferConfig(thres_liver=thresholds[0], thres_tumor=thresholds[1])
    got = TD.DeviceVolumeScorer(from_numpy(HDenseUNet(preset="tiny"), params, state), pcfg,
                                device="cpu").labelmask(vol, lo, hi)
    assert calls and len(calls) % 20 == 0  # 11 a 2D forward and 9 a 3D one, the tiny preset
    assert (got == 1).any() and (got == 3).any()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the card: the kernel against a float64 product of its own operand
# --------------------------------------------------------------------------

# (rows, K, row stride, N, epilogue): the served shape classes at fewer
# rows: 2D bottlenecks and transitions, 3D bottlenecks (K mod 16 = 8, N 128)
# and transitions (N 96, 112, 248), a short M tail, a tile-sized M
CARD_CASES = [
    (36 * 64 * 64 + 5, 96, 384, 192, True),
    (36 * 16 * 16, 2160, 2208, 192, True),
    (9216, 2112, 2112, 1056, False),
    (36864, 768, 768, 384, False),
    (8 * 16 * 16 * 2, 472, 504, 128, True),
    (8 * 64 * 64 * 2 + 3, 104, 104, 128, True),
    (4096 + 64, 192, 192, 96, False),
    (16384, 224, 224, 112, False),
    (4096, 496, 496, 248, False),
    (128, 248, 256, 32, True),
    (77, 96, 104, 192, True),  # M below one 128-row tile
    (4096, 472, 504, 128, True),  # 32 tiles: fewer blocks than SMs, K mod 64 = 24
    (2048 + 40, 2160, 2208, 192, True),  # 17 tiles, K 2160
    (6000, 2160, 2208, 192, True),  # 47 tiles
    (4096 + 77, 496, 496, 248, False),  # N 248 in one 256-wide tile, ragged M
    (9216 + 33, 768, 768, 384, False),  # two 192-wide N tiles, ragged M
    (2304 + 19, 2112, 2112, 1056, False),  # six N tiles, the last half past N
]


def _card_case(cuda, rows, k, ld, n, epilogue, dtype, fill=None):
    """Seeded card inputs: x the first k channels of a (rows, ld) buffer seen
    as (1, K, rows, 1), its channels [k, ld) set to ``fill`` when given."""
    g = torch.Generator(device=cuda).manual_seed(rows + k)
    buf = (2 * torch.randn(rows, ld, device=cuda, generator=g)).to(dtype)
    if fill is not None:
        buf[:, k:] = fill
    x = buf[:, :k].view(1, rows, 1, k).movedim(-1, 1)  # (1, K, rows, 1), rows of stride ld
    w = (torch.randn(n, k, device=cuda, generator=g) * k**-0.5).to(dtype)
    pairs = [(1 + 0.5 * torch.randn(c, device=cuda, generator=g), 0.5 * torch.randn(c, device=cuda, generator=g))
             for c in (k, n)]
    return x, w, (*pairs[0], *(pairs[1] if epilogue else ()))


def _within_float64(x, w, args, got):
    rows, n = x.numel() // x.shape[1], w.shape[0]
    want, tol = K5.float64_reference(x, w, *args)
    err = (got.movedim(1, -1).reshape(rows, n).double() - want).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,k,ld,n,epilogue", CARD_CASES)
def test_cuda_k5_matches_float64(cuda, rows, k, ld, n, epilogue, dtype):
    x, w, args = _card_case(cuda, rows, k, ld, n, epilogue, dtype)
    before = K5.affine_gemm.launches
    got = K5.affine_gemm(x, w, *args)
    torch.cuda.synchronize()
    assert K5.affine_gemm.launches == before + 1
    want, tol = K5.float64_reference(x, w, *args)
    err = (got.movedim(1, -1).reshape(rows, n).double() - want).abs()
    assert bool((err <= tol).all()), float(err.max())
    plain = K5.affine_gemm_reference(x, w, *args) if dtype == torch.bfloat16 else None
    if plain is not None:  # the plain version's product is cuDNN's, its prologue unfused
        _, tol_plain = K5.float64_reference(x, w, *args, fused=False)
        diff = (got.float() - plain.float()).abs().movedim(1, -1).reshape(rows, n).double()
        assert bool((diff <= tol + tol_plain).all()), float(diff.max())


@pytest.mark.parametrize("rows,k,ld,n", [(36 * 16 * 16, 2160, 2208, 192), (4096, 472, 504, 128),
                                         (8 * 16 * 16 * 2, 248, 264, 128)])
def test_cuda_k5_never_reads_past_k(cuda, rows, k, ld, n):
    """The buffer's channels [K, ld) hold NaN (``torch.empty`` leaves any
    bits there): a load that spans ld would read them."""
    x, w, args = _card_case(cuda, rows, k, ld, n, True, torch.bfloat16, fill=float("nan"))
    got = K5.affine_gemm(x, w, *args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _within_float64(x, w, args, got)


@pytest.mark.parametrize("rows,k,ld,n,epilogue", [(36 * 16 * 16, 2160, 2208, 192, True),
                                                  (4096, 472, 504, 128, True),
                                                  (36864, 2112, 2112, 1056, False),
                                                  (36 * 64 * 64, 96, 384, 192, True)])
def test_cuda_k5_repeats_bit_for_bit(cuda, rows, k, ld, n, epilogue):
    """Two calls on the same inputs give the same bytes: each output's sum
    is one block's, in k order, with no atomics."""
    x, w, args = _card_case(cuda, rows, k, ld, n, epilogue, torch.bfloat16)
    first = K5.affine_gemm(x, w, *args)
    second = K5.affine_gemm(x, w, *args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_cuda_k5_refuses_misaligned_operands(cuda):
    x, w, args = _card_case(cuda, 256, 96, 104, 192, True, torch.bfloat16)
    buf = torch.zeros(256 * 104 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(256, 104)[:, :96].view(1, 256, 1, 96).movedim(-1, 1)  # base 2 bytes off
    with pytest.raises(ValueError, match="multiples of 8"):
        K5.affine_gemm(shifted, w, *args)
    odd = torch.zeros(256, 100, dtype=torch.bfloat16, device=cuda)[:, :96].view(1, 256, 1, 96).movedim(-1, 1)
    assert K5.row_stride(odd) == 100
    with pytest.raises(ValueError, match="multiples of 8"):
        K5.affine_gemm(odd, w, *args)


def test_cuda_k5_refuses_grad(cuda):
    """K5 has no backward: under grad mode it raises for an input that
    requires grad instead of returning a result that cuts the graph."""
    x, w, args = _card_case(cuda, 256, 96, 104, 192, True, torch.bfloat16)
    before = K5.affine_gemm.launches
    for leaf in ("x", "w", "scale"):
        xs, ws, a = x.detach(), w.detach(), [t.detach() for t in args]
        {"x": xs, "w": ws, "scale": a[0]}[leaf].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            K5.affine_gemm(xs, ws, *a)
        with torch.no_grad():
            K5.affine_gemm(xs, ws, *a)
    torch.cuda.synchronize()
    assert K5.affine_gemm.launches == before + 3
