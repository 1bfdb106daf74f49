"""The port's execution forms of the 3D branch against the JAX package's,
op by op and branch by branch, on CPU in float32: the d-major layout
(models/dmajor.py), the space-to-depth stem (models/s2d.py) and the z-folded
branch (models/zfold.py); the 3D DenseUNet and the HFF head in every form;
FLOP counts across forms; a checkpoint crossing forms.

Inputs are numpy draws from fixed seeds; weights come from the port's
seeded initializer (numpy draws for single ops) and reach the JAX functions
as the JAX pytree (``params.to_numpy``). Bars: 1e-5 for one op, 2e-5 for the branch (its logits and taps),
float32 summing in another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hdenseunet_tpu.core.module import Ctx as JCtx
from hdenseunet_tpu.models import denseunet3d as J3, dmajor as JDM, hybrid as JH
from hdenseunet_tpu.models import layers as JL, s2d as JS2D, zfold as JZ
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.models import denseunet3d as T3, dmajor, hybrid as TH, s2d, zfold
from hdenseunet_tpu_torch.models import layers as L

OP_TOL = dict(atol=1e-5, rtol=1e-5)
BRANCH_TOL = dict(atol=2e-5, rtol=0)
FORMS = {  # name: the 3D branch's keywords, JAX's and the port's alike
    "hwdc": {},
    "dhwc": dict(layout="dhwc"),
    "hwdc_s2d": dict(stem_s2d=True),
    "dhwc_s2d": dict(layout="dhwc", stem_s2d=True),
    "fold_z": dict(fold_z=True),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _port(x):
    """JAX-layout (B, *S, C) numpy -> the port's (B, C, *S), channels-last."""
    return L.channels_last(torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1))


def _jax(t):
    """The port's (B, C, *S) -> JAX-layout (B, *S, C) numpy."""
    return t.detach().movedim(1, -1).numpy()


def _conv_pair(rng, cin, features, kernel, stride, padding, bias=True):
    """A port Conv and the JAX Ctx holding the same weights under 'w', the
    kernel's scale 1/sqrt(fan-in), so that outputs are of order 1."""
    conv = L.Conv(cin, features, kernel, ndim=3, stride=stride, padding=padding,
                  use_bias=bias, name="w")
    k = L.norm_tuple(kernel, 3)
    std = 1.0 / np.sqrt(np.prod(k) * cin)
    leaves = {"kernel": rng.normal(0, std, k + (cin, features)).astype(np.float32)}
    if bias:
        leaves["bias"] = rng.normal(0, 0.3, features).astype(np.float32)
    P.from_numpy(nn.ModuleDict({"w": conv}), {"w": leaves}, {})
    return conv, JCtx({"w": leaves}, {}, compute_dtype=jnp.float32)


# --------------------------------------------------------------------------
# d-major ops
# --------------------------------------------------------------------------

CONV_CASES = [  # (x shape (B, H, W, D, C), features, kernel, stride, padding)
    ((2, 9, 7, 5, 3), 4, 3, 1, "same"),  # TF-SAME at odd sizes
    ((2, 9, 7, 5, 3), 4, 3, 2, "same"),  # uneven TF split: extra pad at the end
    ((1, 12, 10, 8, 4), 6, 7, 2, 3),
    ((2, 8, 6, 4, 5), 3, 3, 1, 1),
    ((2, 8, 6, 4, 5), 7, 1, 1, "valid"),
    ((1, 9, 8, 6, 3), 5, 3, (1, 2, 2), "same"),
    ((1, 8, 6, 6, 3), 4, (3, 5, 3), 1, (1, 2, 1)),  # a per-axis padding
]


@pytest.mark.parametrize("shape,features,kernel,stride,padding", CONV_CASES)
def test_dmajor_conv_matches_jax(shape, features, kernel, stride, padding):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    conv, jctx = _conv_pair(rng, shape[-1], features, kernel, stride, padding)
    want = JDM.conv3d(jctx, JDM.fold(jnp.asarray(x)), "w", features, kernel, stride=stride,
                      padding=padding)
    with torch.no_grad():
        got = dmajor.conv3d(conv, dmajor.fold(_port(x)))
        direct = conv(_port(x))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(_jax(got), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(_jax(dmajor.unfold(got)), _jax(direct), **OP_TOL)


def test_dmajor_pools_and_upsample_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 12, 10, 8, 3)).astype(np.float32)
    xd_j, xd = JDM.fold(jnp.asarray(x)), dmajor.fold(_port(x))
    pairs = [
        (dmajor.max_pool(xd, 3, 2, pad=1), JDM.max_pool(xd_j, 3, 2, pad=1)),
        (dmajor.max_pool(xd, (3, 3, 1), (2, 2, 1), pad=(1, 1, 0)),
         JDM.max_pool(xd_j, (3, 3, 1), (2, 2, 1), pad=(1, 1, 0))),
        (dmajor.avg_pool(xd, (2, 2, 1), (2, 2, 1)), JDM.avg_pool(xd_j, (2, 2, 1), (2, 2, 1))),
        (dmajor.avg_pool(xd, (2, 2, 2), (2, 2, 2)), JDM.avg_pool(xd_j, (2, 2, 2), (2, 2, 2))),
        (dmajor.upsample_nearest(xd, (2, 2, 1)), JDM.upsample_nearest(xd_j, (2, 2, 1))),
        (dmajor.upsample_nearest(xd, (2, 1, 3)), JDM.upsample_nearest(xd_j, (2, 1, 3))),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.is_contiguous(memory_format=torch.channels_last_3d), i
        np.testing.assert_allclose(_jax(got), np.asarray(want), **OP_TOL, err_msg=str(i))


def test_dmajor_fold_round_trips():
    x = _port(np.random.default_rng(4).normal(size=(2, 6, 5, 4, 3)).astype(np.float32))
    xd = dmajor.fold(x)
    assert tuple(xd.shape) == (2, 3, 4, 6, 5)
    assert torch.equal(dmajor.unfold(xd), x)
    assert dmajor.unfold(xd).is_contiguous(memory_format=torch.channels_last_3d)


# --------------------------------------------------------------------------
# the space-to-depth stem
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_perm", [(0, 1, 2), (2, 0, 1)])
@pytest.mark.parametrize(
    "shape,kernel,padding",
    [((2, 16, 16, 8, 4), 7, 3), ((1, 15, 13, 9, 4), 7, 3), ((1, 11, 10, 7, 3), 5, (2, 1, 2)),
     ((2, 8, 10, 6, 2), 3, 1)],
)
def test_s2d_conv_matches_jax(kernel_perm, shape, kernel, padding):
    """Both kernel orders, even and odd sizes; also against the direct conv
    of the same layer."""
    rng = np.random.default_rng(sum(shape) + kernel)
    x = rng.normal(size=shape).astype(np.float32)
    conv, jctx = _conv_pair(rng, shape[-1], 6, kernel, 2, padding, bias=False)
    xj = jnp.asarray(x)
    if kernel_perm == (2, 0, 1):
        xj = JDM.fold(xj)
    want = JS2D.conv3d_s2d(jctx, xj, "w", 6, kernel, stride=2, padding=padding,
                           kernel_perm=kernel_perm)
    xt = _port(x)
    with torch.no_grad():
        direct = conv(xt)
        if kernel_perm == (2, 0, 1):
            xt, direct = dmajor.fold(xt), dmajor.fold(direct)
        got = s2d.conv3d_s2d(conv, xt, kernel_perm=kernel_perm)
    assert got.shape == direct.shape
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(_jax(got), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(_jax(got), _jax(direct), **OP_TOL)


def test_s2d_gradients_match_the_direct_stem():
    """The repacking is differentiable: the kernel's and the input's
    gradients through s2d equal the direct conv's."""
    rng = np.random.default_rng(9)
    conv, _ = _conv_pair(rng, 4, 8, 7, 2, 3, bias=False)
    x = _port(rng.normal(size=(2, 16, 12, 8, 4)).astype(np.float32))
    g = {}
    for name, fn in (("direct", conv), ("s2d", lambda t: s2d.conv3d_s2d(conv, t))):
        xt = x.clone().requires_grad_()
        conv.kernel.grad = None
        (fn(xt) ** 2).sum().backward()
        g[name] = (conv.kernel.grad.clone(), xt.grad)
    for a, b in zip(g["s2d"], g["direct"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# z-folded ops
# --------------------------------------------------------------------------

ZFOLD_CASES = [  # (x shape, features, kernel, stride, padding)
    ((2, 16, 16, 8, 6), 10, 1, 1, "valid"),
    ((2, 16, 16, 8, 6), 5, 3, 1, 1),
    ((2, 16, 16, 8, 6), 7, 3, 1, "same"),
    ((2, 16, 16, 8, 6), 9, 7, 2, 3),
    ((1, 12, 12, 10, 4), 5, 3, 1, (1, 1, 1)),
    ((1, 12, 12, 10, 4), 6, 7, 2, (3, 3, 3)),
    ((1, 12, 12, 10, 4), 5, 3, (1, 1, 2), "same"),
    ((2, 12, 10, 8, 4), 5, (3, 3, 1), 1, "same"),  # kz = 1: a plain 2D conv
    ((2, 9, 11, 6, 3), 4, 3, (2, 2, 1), "same"),  # uneven TF split in x and y
]


def _pack_limit(mode, shape, features, kernel, stride, padding):
    """The packed-intermediate bound that sends conv3d down ``mode``'s path:
    'one_shot' (the default bound), 'windows' (one window fits, the batch
    does not), 'z1' (nothing fits: one output z a chunk) or 'z2' (two
    output z a chunk)."""
    if mode == "one_shot":
        return 1 << 30
    if mode == "z1":
        return 1
    b, h, w, d, _ = shape
    kh, kw, kz = L.norm_tuple(kernel, 3)
    sh, sw, sz = L.norm_tuple(stride, 3)
    pad_hw = padding if isinstance(padding, (str, int)) else padding[:2]
    (ph, pw) = L.conv_padding((h, w), (kh, kw), (sh, sw), pad_hw)
    hw = ((h + sum(ph) - kh) // sh + 1) * ((w + sum(pw) - kw) // sw + 1)
    lo, hi = zfold._z_pads(d, kz, sz, padding)
    if mode == "windows":
        return (d + lo + hi) * hw * kz * features * 4
    return (sz + kz) * b * hw * kz * features * 4  # 'z2'


@pytest.mark.parametrize(
    "shape,features,kernel,stride,padding,mode",
    [case + (mode,) for case in ZFOLD_CASES for mode in ("one_shot", "windows", "z1", "z2")
     if mode != "windows" or case[0][0] > 1],  # windows one by one: a batch of several
)
def test_zfold_conv_matches_jax(shape, features, kernel, stride, padding, mode, monkeypatch):
    """The tap-packed conv against JAX's zfold.conv3d on the same path, with
    the packed-intermediate bound lowered as tests/test_models.py lowers it,
    and against the direct conv."""
    limit = _pack_limit(mode, shape, features, kernel, stride, padding)
    monkeypatch.setattr(zfold, "_MAX_PACK_BYTES", limit)
    monkeypatch.setattr(JZ, "_MAX_PACK_BYTES", limit)
    rng = np.random.default_rng(sum(shape) + features)
    x = rng.normal(size=shape).astype(np.float32)
    conv, jctx = _conv_pair(rng, shape[-1], features, kernel, stride, padding)
    xf_j, b, d = JZ.fold(jnp.asarray(x))
    yf_j, d_j = JZ.conv3d(jctx, xf_j, b, d, "w", features, kernel, stride=stride, padding=padding)
    xf, b2, d2 = zfold.fold(_port(x))
    assert (b2, d2) == (b, d)
    with torch.no_grad():
        yf, d_out = zfold.conv3d(conv, xf, b, d)
        direct = conv(_port(x))
    assert d_out == d_j
    assert yf.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_jax(yf), np.asarray(yf_j), **OP_TOL)
    np.testing.assert_allclose(_jax(zfold.unfold(yf, b, d_out)), _jax(direct), **OP_TOL)


def test_zfold_paths_are_taken(monkeypatch):
    """Each bound of _pack_limit takes the path it names: the windows'
    path runs one conv a window, the chunked paths one a chunk."""
    shape, features, kernel, stride, padding = (2, 12, 10, 8, 4), 5, 3, 1, "same"
    calls = []
    real = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d", lambda x, *a, **k: calls.append(x.shape[0]) or real(x, *a, **k))
    conv, _ = _conv_pair(np.random.default_rng(0), shape[-1], features, kernel, stride, padding)
    xf, b, d = zfold.fold(_port(np.zeros(shape, np.float32)))
    seen = {}
    for mode in ("one_shot", "windows", "z1", "z2"):
        monkeypatch.setattr(zfold, "_MAX_PACK_BYTES", _pack_limit(mode, shape, features, kernel, stride, padding))
        calls.clear()
        with torch.no_grad():
            zfold.conv3d(conv, xf, b, d)
        seen[mode] = list(calls)
    # one conv over both windows; one a window; 8 chunks of 1 and 4 of 2
    # output z, each reading its z taps' halo (kz - 1 = 2 more slices)
    assert seen == {"one_shot": [16], "windows": [8, 8], "z1": [6] * 8, "z2": [8] * 4}


ZFOLD_POOLS = [  # (label, port op, JAX op, the direct op), window arguments canonical
    ("max 3/2 pad 1", zfold.max_pool, JZ.max_pool, JL.max_pool, (3, 2), {"pad": 1}),
    ("max 3/1 pad 1", zfold.max_pool, JZ.max_pool, JL.max_pool, (3, 1), {"pad": 1}),
    ("avg 2,2,1", zfold.avg_pool, JZ.avg_pool, JL.avg_pool, ((2, 2, 1), (2, 2, 1)), {}),
    ("avg 2,2,2", zfold.avg_pool, JZ.avg_pool, JL.avg_pool, ((2, 2, 2), (2, 2, 2)), {}),
    ("up 2,2,1", zfold.upsample_nearest, JZ.upsample_nearest, JL.upsample_nearest, ((2, 2, 1),), {}),
    ("up 2,2,2", zfold.upsample_nearest, JZ.upsample_nearest, JL.upsample_nearest, ((2, 2, 2),), {}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zfold_pools_and_upsample_match_jax(dtype):
    """Pools and repeats of the folded tensor against JAX's: in bfloat16
    too, where each window's float32 sum is exact and both sides round it
    once a step (the 2D pool, then the z average), so the bits agree; in
    float32 also against the direct 3D op."""
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 8, 3)).astype(np.float32)
    xf_j, b, d = JZ.fold(jnp.asarray(x, getattr(jnp, dtype)))
    xf, _, _ = zfold.fold(_port(x).to(getattr(torch, dtype)))
    for label, port_op, jax_op, direct_op, args, kw in ZFOLD_POOLS:
        (got, d_got), (want, d_want) = port_op(xf, b, d, *args, **kw), jax_op(xf_j, b, d, *args, **kw)
        assert d_got == d_want, label
        assert got.is_contiguous(memory_format=torch.channels_last), label
        np.testing.assert_array_equal(
            _jax(got.float()), np.asarray(want.astype(jnp.float32)), err_msg=label
        )
        if dtype == "float32":
            np.testing.assert_allclose(
                _jax(zfold.unfold(got, b, d_got)), np.asarray(direct_op(jnp.asarray(x), *args, **kw)),
                **OP_TOL, err_msg=label,
            )


def test_zfold_fold_round_trips():
    x = _port(np.random.default_rng(5).normal(size=(2, 6, 5, 4, 3)).astype(np.float32))
    xf, b, d = zfold.fold(x)
    assert tuple(xf.shape) == (8, 3, 6, 5) and xf.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_jax(xf), np.asarray(JZ.fold(jnp.asarray(_jax(x)))[0]))
    assert torch.equal(zfold.unfold(xf, b, d), x)


# --------------------------------------------------------------------------
# the 3D branch and the HFF head in every form
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def branch():
    """A tiny 3D DenseUNet from the port's seeded initializer, its weights
    as the JAX pytree, and a batch of two 32x32x8 inputs."""
    model = init_model(T3.DenseUNet3D(**T3.PRESETS["tiny"]), 8)
    x = np.random.default_rng(12).normal(0, 1, (2, 32, 32, 8, 4)).astype(np.float32)
    return model, P.to_numpy(model), x


@pytest.fixture(scope="module")
def hybrid():
    """A tiny hybrid from the port's seeded initializer and its weights as
    the JAX pytree."""
    model = init_model(TH.HDenseUNet(preset="tiny"), 9)
    return model, P.to_numpy(model)


@pytest.mark.parametrize("form", list(FORMS))
def test_denseunet3d_matches_jax_in_each_form(branch, form):
    """Features, logits and every tap against denseunet3d.apply in the same
    form; the taps are canonical in every form."""
    model, (p, s), x = branch
    kw = FORMS[form]
    jtaps, ptaps = {}, {}
    want = J3.apply(JCtx(p, s), jnp.asarray(x), taps=jtaps, **kw, **J3.PRESETS["tiny"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x), taps=ptaps, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BRANCH_TOL)
    assert ptaps.keys() == jtaps.keys()
    for name, w in jtaps.items():
        assert tuple(ptaps[name].shape) == w.shape, name
        np.testing.assert_allclose(ptaps[name].numpy(), np.asarray(w), **BRANCH_TOL, err_msg=name)


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_denseunet3d_dmajor_outputs_stay_dmajor(branch, stem_s2d):
    """unfold_outputs=False hands both outputs over d-major, (B, D, H, W, C),
    as JAX's; the asserts refuse what JAX refuses."""
    model, (p, s), x = branch
    want = J3.apply(JCtx(p, s), jnp.asarray(x), layout="dhwc", unfold_outputs=False,
                    stem_s2d=stem_s2d, **J3.PRESETS["tiny"])
    with torch.inference_mode():
        got = model(torch.from_numpy(x), layout="dhwc", unfold_outputs=False, stem_s2d=stem_s2d)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BRANCH_TOL)
        xt = torch.from_numpy(x)
        for kw in (dict(fold_z=True, layout="dhwc"), dict(fold_z=True, stem_s2d=True),
                   dict(unfold_outputs=False), dict(layout="dwhc")):
            with pytest.raises(AssertionError):
                model(xt, **kw)


@pytest.mark.parametrize("form", ["dhwc_s2d", "fold_z"])
def test_denseunet3d_live_statistics_match_jax(branch, form):
    """Training mode, live BNs: each form's new moving statistics (the same
    element sets reduced) against JAX's in the same form."""
    model, (p, s), x = branch
    jctx = JCtx(p, s, train=True, rng=jax.random.key(0))
    J3.apply(jctx, jnp.asarray(x), **FORMS[form], **J3.PRESETS["tiny"])
    ctx = L.Ctx(0, device="cpu")
    with torch.no_grad():
        model(torch.from_numpy(x), ctx, **FORMS[form])
    names = {layer: name for name, layer in P.layers(model).items()}
    assert {names[bn] for bn in ctx.new_stats} == set(jctx.new_state)
    for bn, (mean, var) in ctx.new_stats.items():
        want = jctx.new_state[names[bn]]
        np.testing.assert_allclose(mean.numpy(), np.asarray(want["moving_mean"]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(var.numpy(), np.asarray(want["moving_variance"]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("form", ["hwdc", "dhwc", "fold_z"])
def test_hff_head_matches_jax_in_each_form(hybrid, form):
    """The d-major head takes the 3D features d-major and folds fea2d
    itself; every form's logits come out canonical."""
    model, (p, s) = hybrid[0].head, hybrid[1]
    width = J3.PRESETS["tiny"]["decoder_widths"][-1]
    rng = np.random.default_rng(4)
    f3, f2 = (rng.normal(0, 1, (2, 32, 32, 8, width)).astype(np.float32) for _ in range(2))
    kw = {"dhwc": dict(layout="dhwc"), "fold_z": dict(fold_z=True)}.get(form, {})
    f3_in = np.ascontiguousarray(f3.transpose(0, 3, 1, 2, 4)) if form == "dhwc" else f3
    want = JH.hff_head(JCtx(p, s), jnp.asarray(f3_in), jnp.asarray(f2), arch="3dpart", **kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(f3_in), torch.from_numpy(f2), arch="3dpart", **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("form", ["dhwc", "hwdc_s2d", "dhwc_s2d"])
def test_hybrid_forms_match_jax(hybrid, form):
    """hybrid.apply with layout3d and stem_s2d against the port's forward
    in the same form, fusion taps included (feat3d canonical)."""
    model, (p, s) = hybrid
    vol = np.random.default_rng(7).normal(0, 50, (1, 32, 32, 8, 1)).astype(np.float32)
    kw = dict(layout3d=FORMS[form].get("layout", "hwdc"), stem_s2d=FORMS[form].get("stem_s2d", False))
    jtaps, ptaps = {}, {}
    want = JH.apply(JCtx(p, s), jnp.asarray(vol), preset="tiny", taps=jtaps, **kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(vol), taps=ptaps, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BRANCH_TOL)
    for name in ("feat3d", "2d3dclassifer"):
        np.testing.assert_allclose(ptaps[name].numpy(), np.asarray(jtaps[name]), **BRANCH_TOL,
                                   err_msg=name)


# --------------------------------------------------------------------------
# FLOP counts and checkpoints across forms
# --------------------------------------------------------------------------


def _jax_flop_table(apply_fn, shape, **kw):
    ctx = JCtx(record=True, train=False)
    ctx.flops, ctx.flop_table = [0.0], {}
    jax.eval_shape(lambda v: apply_fn(ctx, v, **kw), jax.ShapeDtypeStruct(shape, np.float32))
    return ctx.flop_table


@pytest.mark.parametrize("form", list(FORMS))
def test_flop_tables_equal_across_forms_and_jax(form):
    """The useful FLOPs per layer name, on the meta device: each form's
    table equals the direct form's (no zero tap of s2d, no recomputed z row
    of the folded strided stem) and JAX's table in the same form."""
    shape = (2, 64, 32, 12, 4)
    net = T3.DenseUNet3D(**T3.PRESETS["tiny"], device="meta")
    tables = {}
    for name, kw in (("hwdc", {}), (form, FORMS[form])):
        tables[name] = {}
        with torch.no_grad(), L.count_flops(tables[name]):
            net(torch.empty(shape, device="meta"), **kw)
    assert tables[form] == tables["hwdc"]
    assert tables[form] == _jax_flop_table(J3.apply, shape, **FORMS[form], **J3.PRESETS["tiny"])


@pytest.mark.parametrize("layout3d", ["hwdc", "dhwc"])
@pytest.mark.parametrize("stem_s2d", [False, True])
def test_executed_flops_equal_the_estimate_in_each_form(layout3d, stem_s2d):
    """A tiny scoring run with the counter open counts exactly
    estimate_flops, which counts the canonical graph, in every form the
    scorer reaches."""
    import dataclasses

    from hdenseunet_tpu_torch.core.config import InferConfig
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = dataclasses.replace(InferConfig(), layout3d=layout3d, stem_s2d=stem_s2d)
    scorer = DeviceVolumeScorer(init_model(HDenseUNet(preset="tiny"), 0), cfg, device="cpu")
    vol = np.random.default_rng(0).normal(0, 50, (32, 32, 20)).astype(np.float32)
    with L.count_flops() as counter:
        scorer.score(vol, 4, 12)
    assert counter.total == scorer.estimate_flops(vol.shape, 4, 12) > 0


def test_checkpoint_crosses_forms(tmp_path):
    """Parameters are stored canonically in every form: an end2end run in
    the d-major form with the s2d stem saves a checkpoint; a state of the
    direct form restores it bit for bit and serves the same logits."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.train import checkpoint as C, trainer as T

    def cfg(layout3d, stem_s2d):
        c = Config()
        c.model.preset, c.model.input_size, c.model.input_cols = "tiny", 32, 8
        c.model.layout3d, c.model.stem_s2d = layout3d, stem_s2d
        c.train.arch, c.train.batch, c.train.save_path = "end2end", 2, str(tmp_path / "exp")
        return c

    batches = synthetic_batches(mode="hybrid", batch=2, input_size=32, input_cols=8, seed=1)
    saved = T.train(cfg("dhwc", True), batches, max_steps=2, device="cpu",
                    checkpoint_dir=str(tmp_path / "ck"), log_fn=lambda *a: None)
    restored = T.create_train_state(cfg("hwdc", False), "end2end", device="cpu", seed=5)
    C.apply(C.load(C.step_files(tmp_path / "ck")[2]), restored)
    assert restored.step == 2
    for (name, a), (_, b) in zip(saved.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), name
    vol = torch.from_numpy(np.random.default_rng(2).normal(0, 50, (1, 32, 32, 8, 1)).astype(np.float32))
    with torch.inference_mode():
        want = saved.model(vol, layout3d="dhwc", stem_s2d=True)
        got = restored.model(vol)
    torch.testing.assert_close(got, want, **BRANCH_TOL)
