"""K6, the live-statistics BatchNorm∘[Scale]∘[ReLU] of a training forward
(``ops/bn_live.py``, ``csrc/bn_live.cu``), and the model sites that call it.

On the CPU: the plain version, forward and backward, against autograd of
the three-op chain (BatchNorm, Scale, ReLU) in float64; the moving
statistics as the chain wrote them; remat on and off; a mesh of several
ranks calling K6 with its group; the merge of 2, 3 and 4 ranks' moments
against the whole batch's; the two-phase path with an identity merge
giving the one-rank bits; a CUDA tensor not rows-contiguous refused; the
``bn_live`` count of a step. On the card (the ``cuda`` fixture): the
kernels against the plain version at the training cells' shapes, two
calls the same bits, phase 1 then phase 2 the bits of one call, a
captured graph's replay equal to the eager call.
"""
from __future__ import annotations

import pytest
import torch

from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.models import denseunet2d
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops import bn_live as K
from hdenseunet_tpu_torch.utils import profiling

EPS = 1.1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows_layout(x):
    """x (channels on axis 1) in channels-last memory for its rank."""
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


def _params(c, gen, dtype=torch.float64, device="cpu"):
    """gamma_bn, beta_bn, gamma_s, beta_s."""
    def normal(mean, sd):
        return (mean + sd * torch.randn(c, generator=gen, dtype=torch.float64)).to(device, dtype)

    return normal(1.0, 0.3), normal(0.0, 0.5), normal(1.0, 0.3), normal(0.0, 0.5)


def _chain(x, gb, bb, gs, bs, eps, *, scale, relu):
    """BatchNorm with batch statistics, then Scale, then ReLU: the three
    plain ops the live sites ran before K6, all in x's dtype."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1] * x.dim()
    shape[1] = -1
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    inv = torch.rsqrt(var + eps) * gb
    y = x * inv.view(shape) + (bb - mean * inv).view(shape)
    if scale:
        y = y * gs.view(shape) + bs.view(shape)
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("shape", [(3, 12, 5, 6), (2, 13, 4, 3, 5), (2, 16, 4, 4, 2)])
def test_plain_matches_the_three_op_chain_in_float64(shape, scale, relu):
    """Output, batch statistics and the gradients of x and of every BN and
    Scale leaf: ``BNLive`` (the plain forward and backward on the CPU)
    against autograd of the chain, in float64, 4-D and 5-D, C % 8 != 0."""
    gen = torch.Generator().manual_seed(sum(shape) + 2 * scale + relu)
    x = _rows_layout(0.5 + 2 * torch.randn(shape, generator=gen, dtype=torch.float64))
    g = torch.randn(shape, generator=gen, dtype=torch.float64)
    leaves = [t.requires_grad_() for t in _params(shape[1], gen)]
    x.requires_grad_()
    gb, bb, gs, bs = leaves
    y, mean, var = K.BNLive.apply(x, gb, bb, gs if scale else None, bs if scale else None, EPS, relu)
    want = _chain(x, *leaves, EPS, scale=scale, relu=relu)
    inputs = [x, gb, bb] + ([gs, bs] if scale else [])
    got_grads = torch.autograd.grad((y * g).sum(), inputs)
    want_grads = torch.autograd.grad((want * g).sum(), inputs)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    dims = [d for d in range(x.dim()) if d != 1]
    want_var, want_mean = torch.var_mean(x.detach(), dim=dims, correction=0)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    assert not mean.requires_grad and not var.requires_grad
    for name, a, b in zip(["x", "gamma_bn", "beta_bn", "gamma_s", "beta_s"], got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)
    assert y.stride() == x.stride()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_new_stats_as_the_chain_wrote_them(dtype):
    """BatchNorm, bn_scale_relu and bn_relu with live statistics assign
    momentum*moving + (1-momentum)*batch from torch.var_mean of x in
    float32, the same bits as before K6; their outputs agree with the chain
    computed in float32 within one rounding to the dtype."""
    gen = torch.Generator().manual_seed(3)
    c = 20
    x = _rows_layout((1 + 3 * torch.randn((4, c, 6, 5), generator=gen)).to(dtype))
    bn, sc = L.BatchNorm(c, eps=EPS), L.Scale(c)
    with torch.no_grad():
        for t, v in zip([bn.gamma, bn.beta, sc.gamma, sc.beta], _params(c, gen, torch.float32)):
            t.copy_(v)
        bn.moving_mean.copy_(torch.randn(c, generator=gen))
        bn.moving_variance.copy_(torch.rand(c, generator=gen) + 0.5)
    var, mean = torch.var_mean(x.float(), dim=[0, 2, 3], correction=0)
    want_stats = (0.99 * bn.moving_mean + 0.01 * mean, 0.99 * bn.moving_variance + 0.01 * var)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-8, atol=2**-8)
    calls = {
        "bn": (lambda ctx: bn(x, ctx), dict(scale=False, relu=False)),
        "bn_scale_relu": (lambda ctx: L.bn_scale_relu(x, bn, sc, ctx=ctx), dict(scale=True, relu=True)),
        "bn_relu": (lambda ctx: L.bn_relu(x, bn, ctx), dict(scale=False, relu=True)),
    }
    for name, (call, kind) in calls.items():
        ctx = L.Ctx(0, device="cpu")
        with torch.no_grad():
            y = call(ctx)
            want = _chain(x.float(), bn.gamma, bn.beta, sc.gamma, sc.beta, EPS, **kind)
        for got, expect in zip(ctx.new_stats[bn], want_stats):
            assert torch.equal(got, expect), name
        assert y.dtype == dtype and y.stride() == x.stride(), name
        torch.testing.assert_close(y.float(), want, **tol, msg=name)


def _tiny_2d(seed=0):
    return init_model(denseunet2d.DenseUNet2D(**denseunet2d.PRESETS["tiny"]), seed)


def _grads_of_a_step(model, remat, policy="full"):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 32, 32, 3), generator=gen)
    ctx = L.Ctx(5, device="cpu", remat=remat, remat_policy=policy)
    _, logits = model(x, ctx, decoder_dropout=0.3, block_dropout=0.2)
    model.zero_grad()
    loss = (logits.float() ** 2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, {bn: s for bn, s in ctx.new_stats.items()}


@pytest.mark.parametrize("policy", ["full", "convs"])
def test_same_step_with_remat_on_and_off(policy):
    """The tiny 2D network's loss, every gradient and every new moving
    statistic, the same bits with remat on (each conv block's K6 calls
    rerun in the backward) and off."""
    model = _tiny_2d()
    loss0, grads0, stats0 = _grads_of_a_step(model, remat=False)
    loss1, grads1, stats1 = _grads_of_a_step(model, remat=True, policy=policy)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    assert stats0.keys() == stats1.keys() and len(stats0) == 26
    for bn in stats0:
        assert all(torch.equal(a, b) for a, b in zip(stats0[bn], stats1[bn]))


def test_several_ranks_call_k6_with_the_group(monkeypatch):
    """Under a mesh of several ranks (``ctx.group`` set) BatchNorm,
    bn_scale_relu and bn_relu each make one K6 call, ``BNLive`` given the
    group, which merges their statistics across ranks."""
    gen = torch.Generator().manual_seed(4)
    c = 8
    x = _rows_layout(torch.randn((2, c, 4, 4), generator=gen))
    bn, sc = L.BatchNorm(c, eps=EPS), L.Scale(c)
    with torch.no_grad():
        for t, v in zip([bn.gamma, bn.beta, sc.gamma, sc.beta], _params(c, gen, torch.float32)):
            t.copy_(v)
        bn.moving_mean.zero_()
        bn.moving_variance.fill_(1.0)
    seen = []
    apply = K.BNLive.apply

    def spy(*args):
        seen.append((args[3] is sc.gamma, args[6], args[7]))
        return apply(*args[:7])

    monkeypatch.setattr(K.BNLive, "apply", spy)
    group = object()
    for call in (lambda ctx: bn(x, ctx), lambda ctx: L.bn_scale_relu(x, bn, sc, ctx=ctx),
                 lambda ctx: L.bn_relu(x, bn, ctx)):
        ctx = L.Ctx(0, device="cpu")
        ctx.group = group
        y = call(ctx)
        assert y.shape == x.shape and bn in ctx.new_stats
    assert seen == [(False, False, group), (True, True, group), (False, True, group)]


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_merged_moments_are_the_whole_batch(ranks):
    """``fold_moments`` of the rows ``merge_moments`` all-reduces (each
    rank's float64 mean, biased variance and row count, ranks of unequal
    rows) against torch.var_mean of the whole batch in float64."""
    gen = torch.Generator().manual_seed(ranks)
    c = 7
    x = 3.0 + 2.0 * torch.randn((6 * ranks + 1, c), generator=gen, dtype=torch.float64)
    rows = []
    for part in torch.tensor_split(x, ranks):
        var, mean = torch.var_mean(part, dim=0, correction=0)
        rows.append(torch.cat([mean, var, part.new_tensor([len(part)])]))
    merged = K.fold_moments(torch.stack(rows))
    want_var, want_mean = torch.var_mean(x, dim=0, correction=0)
    torch.testing.assert_close(merged[:c], want_mean, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(merged[c:2 * c], want_var, rtol=1e-13, atol=1e-14)
    assert float(merged[-1]) == len(x)


def _identity_merge(monkeypatch):
    """A merge over one rank: this rank's sums and its row count, as the
    (2C + 1) float64 that ``merge_moments``/``merge_sums`` return."""
    def merge(local, rows, group):
        return torch.cat([local.reshape(-1).double(), local.new_tensor([rows], dtype=torch.float64)])

    monkeypatch.setattr(K, "merge_moments", merge)
    monkeypatch.setattr(K, "merge_sums", merge)


def _both_ways(x, g, gb, bb, gs, bs, relu, group):
    y, mean, var, coef = K.bn_live_forward(x, gb, bb, gs, bs, eps=EPS, relu=relu, group=group)
    dx, grads = K.bn_live_backward(g, x, mean, coef, gb, bb, gs, relu=relu, group=group)
    return y, mean, var, coef, dx, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_phases_with_an_identity_merge_give_one_rank_bits(monkeypatch, dtype):
    """The plain version's several-rank path (statistics, merge, apply;
    S1/S2, merge, dx) with a merge over one rank: every output the one-rank
    path's bits, forward and backward, with and without Scale and ReLU."""
    _identity_merge(monkeypatch)
    gen = torch.Generator().manual_seed(9)
    x = _rows_layout((0.5 + 2 * torch.randn((3, 12, 5, 4), generator=gen)).to(dtype))
    g = torch.randn(x.shape, generator=gen).to(dtype)
    gb, bb, gs, bs = _params(12, gen, torch.float32)
    for scale, relu in ((True, True), (False, False)):
        args = (x, g, gb, bb, gs if scale else None, bs if scale else None, relu)
        for a, b in zip(_both_ways(*args, None), _both_ways(*args, object())):
            assert a.dtype == b.dtype and torch.equal(a, b)


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA card."""

    @property
    def is_cpu(self):
        return False

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_tensor_not_rows_contiguous_raises(which):
    """A CUDA tensor whose memory is not a (rows, C) matrix is refused
    before any launch: there is no fallback to the plain version."""
    c = 8
    x = torch.randn((2, c, 4, 4)).as_subclass(_CudaLike)  # channels-first: not rows-contiguous
    assert x.is_cuda and not x.is_cpu and not L.channels_last(x).is_contiguous()
    gb, bb, gs, bs = _params(c, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="channels-last"):
        if which == "forward":
            K.bn_live_forward(x, gb, bb, gs, bs, eps=EPS, relu=True)
        else:
            K.bn_live_backward(x, x, torch.zeros(c), torch.ones((3, c)), gb, bb, gs, relu=True)


def _bn_live_count(model, x, run):
    """``bn_live`` counted by the program's recorder over ``run(model, x)``."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run(model, x)
    counts = profiling.snapshot()["counts"]
    profiling.reset()
    return counts.get("bn_live", 0)


def _step(remat):
    def run(model, x):
        _, logits = model(x, L.Ctx(0, device=x.device, remat=remat), decoder_dropout=0.3)
        logits.float().sum().backward()
    return run


def _sites(model):
    """(live BN sites, those inside a conv block) of a 2D network."""
    bns = [name for name, m in model.items() if isinstance(m, L.BatchNorm)]
    return len(bns), sum(name.endswith(("_x1_bn", "_x2_bn")) for name in bns)


@pytest.mark.parametrize("remat", [False, True])
def test_a_step_counts_its_live_sites(remat):
    """``bn_live`` (read by the benchmark's ``bn_live_calls.eager``): one
    a live BN site a step, and one more for each site inside a conv block
    that remat recomputes. The tiny 2D network on the CPU: 26 sites, 16 in
    conv blocks; DenseUNet-167 at d167.train.*'s batch of 10 x 224x224x3
    on the meta device: 166 and 156, 322 calls a step under remat."""
    tiny = _tiny_2d()
    sites, in_blocks = _sites(tiny)
    assert (sites, in_blocks) == (26, 16)
    x = torch.randn((2, 32, 32, 3))
    assert _bn_live_count(tiny, x, _step(remat)) == sites + remat * in_blocks
    full = denseunet2d.DenseUNet2D(device="meta")
    sites, in_blocks = _sites(full)
    assert (sites, in_blocks) == (166, 156)
    x = torch.empty((10, 224, 224, 3), device="meta", dtype=torch.bfloat16)
    assert _bn_live_count(full, x, _step(remat)) == sites + remat * in_blocks


# --- on the card ------------------------------------------------------------

# (rows, C, dtype, scale, relu): the graphed cells' live sites, d167.train.*
# at batch 10 of 224x224 (stage 1 to 5 and the decoder's last BN) and
# hdu.train.end2end at 8 x 224x224x8 (the 3D stages, the head's BN), then a
# float32 case, C % 8 != 0 (the scalar path) and one at C = 1.
CARD_SHAPES = [
    (125_440, 96, torch.bfloat16, True, True),
    (31_360, 288, torch.bfloat16, True, True),
    (7_840, 720, torch.bfloat16, True, True),
    (1_960, 2_112, torch.bfloat16, True, True),
    (490, 2_160, torch.bfloat16, True, True),
    (501_760, 64, torch.bfloat16, False, True),
    (401_408, 96, torch.bfloat16, True, True),
    (3_136, 504, torch.bfloat16, True, True),
    (3_211_264, 64, torch.bfloat16, False, True),
    (12_544, 96, torch.float32, True, False),
    (4_099, 36, torch.bfloat16, False, False),
    (1_000, 1, torch.float32, True, True),
]


def _card_case(rows, c, dtype, scale, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (0.7 + 2 * torch.randn((rows, c), device=device, generator=gen)).to(dtype)
    g = torch.randn((rows, c), device=device, generator=gen).to(dtype)
    gb, bb, gs, bs = _params(c, torch.Generator().manual_seed(seed), torch.float32, device)
    return x, g, gb, bb, (gs if scale else None), (bs if scale else None)


def _run(x, g, gb, bb, gs, bs, relu):
    y, mean, var, coef = K.bn_live_forward(x, gb, bb, gs, bs, eps=EPS, relu=relu)
    dx, grads = K.bn_live_backward(g, x, mean, coef, gb, bb, gs, relu=relu)
    return y, mean, var, coef, dx, grads


@pytest.mark.parametrize("case", CARD_SHAPES, ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}-s{int(c[3])}r{int(c[4])}")
def test_cuda_kernel_matches_plain(cuda, case):
    """The kernels against the plain version on the same card. Statistics:
    the kernel's fp32 Welford folded in double against torch.var_mean, both
    within a few fp32 ulps of the exact moments: mean within 2^-20 of
    sqrt(mean^2 + var), var within 2^-18 relative; inv and A within 2^-16
    relative, B within 2^-16 of its terms' magnitudes (it may cancel).
    The outputs from
    the kernel's own statistics: y the same bits as the plain multiply and
    add (both round twice in fp32, then once to the dtype); dx within one
    ulp of the dtype plus 2^-20 of the magnitudes of its three terms
    (fmaf against separate roundings); the parameter gradients, fp32 sums
    in other orders, within 2^-16 of the sums of magnitudes."""
    rows, c, dtype, scale, relu = case
    x, g, gb, bb, gs, bs = _card_case(rows, c, dtype, scale, cuda)
    y, mean, var, coef, dx, grads = _run(x, g, gb, bb, gs, bs, relu)
    _, want_mean, want_var, want_coef = K.bn_live_reference(x, gb, bb, gs, bs, eps=EPS, relu=relu)
    torch.cuda.synchronize()
    size = torch.sqrt(want_mean ** 2 + want_var)
    assert bool(((mean - want_mean).abs() <= 2**-20 * size).all()), (mean - want_mean).abs().max()
    assert bool(((var - want_var).abs() <= 2**-18 * want_var + 1e-30).all()), (var - want_var).abs().max()
    inv, a, b = coef
    gsv = torch.ones_like(gb) if gs is None else gs
    torch.testing.assert_close(coef[:2], want_coef[:2], rtol=2**-16, atol=0)
    # B = (beta_bn - mean*inv*gamma_bn)*gamma_s + beta_s may cancel: its
    # error is relative to its terms' magnitudes
    terms_b = (bb.abs() + (want_mean * want_coef[0] * gb).abs()) * gsv.abs() + (0 if bs is None else bs.abs())
    assert bool(((b - want_coef[2]).abs() <= 2**-16 * terms_b).all()), (b - want_coef[2]).abs().max()
    want_y = (x.float() * a + b)
    want_y = (torch.relu(want_y) if relu else want_y).to(dtype)
    assert torch.equal(y, want_y)
    want_dx, want_grads = K.bn_live_backward_reference(g, x, mean, coef, gb, bb, gs, relu=relu)
    xf, gf = x.float(), g.float()
    if relu:
        gf = torch.where(xf * a + b > 0, gf, 0.0)
    c1 = gb * gsv * inv
    s1, s2 = gf.abs().sum(0), (gf * (xf - mean) * inv).abs().sum(0)
    terms = c1.abs() * gf.abs() + (c1 * s1 / rows).abs() + (c1 * s2 * inv / rows).abs() * (xf - mean).abs()
    tol = torch.finfo(dtype).eps * want_dx.float().abs() + 2**-20 * terms
    assert bool(((dx.float() - want_dx.float()).abs() <= tol).all()), (dx.float() - want_dx.float()).abs().max()
    mags = torch.stack([gsv.abs() * s2, gsv.abs() * s1, gb.abs() * s2 + bb.abs() * s1, s1])
    if gs is None:
        mags[2:] = 0
    assert bool(((grads - want_grads).abs() <= 2**-16 * mags + 1e-30).all()), (grads - want_grads).abs().max()
    assert dx.stride() == x.stride() and y.stride() == x.stride()


def test_cuda_two_calls_are_the_same_bits(cuda):
    """Forward and backward twice at one of end2end's 3D shapes and one
    of d167's: no float atomics, a fixed order of every sum."""
    for rows, c, dtype, scale, relu in (CARD_SHAPES[7], CARD_SHAPES[3]):
        case = _card_case(rows, c, dtype, scale, cuda, seed=5)
        first = _run(*case, relu)
        second = _run(*case, relu)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_phase_1_then_phase_2_give_the_bits_of_one_call(cuda, monkeypatch, which):
    """The several-rank entry points, phase 1 (the reduction's unrounded
    double sums) then phase 2 (their finish and the apply) with an identity
    merge between them: the bits of the one-rank call (phase 0) at every
    card shape, forward or backward."""
    for rows, c, dtype, scale, relu in CARD_SHAPES:
        x, g, gb, bb, gs, bs = _card_case(rows, c, dtype, scale, cuda, seed=3)
        one = _run(x, g, gb, bb, gs, bs, relu)
        with monkeypatch.context() as m:
            _identity_merge(m)
            if which == "forward":
                two = K.bn_live_forward(x, gb, bb, gs, bs, eps=EPS, relu=relu, group=object())
                one = one[:4]
            else:
                two = K.bn_live_backward(g, x, one[1], one[3], gb, bb, gs, relu=relu, group=object())
                one = one[4:]
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b), (rows, c, dtype)


def test_cuda_graph_replay_equals_the_eager_call(cuda):
    """BNLive forward and backward captured in a CUDA graph, replayed on new
    inputs copied into the captured ones: the eager call's bits."""
    from hdenseunet_tpu_torch.ops import build

    rows, c, dtype, scale, relu = CARD_SHAPES[1]
    x0, g0, gb, bb, gs, bs = _card_case(rows, c, dtype, scale, cuda, seed=1)
    x1, g1, *_ = _card_case(rows, c, dtype, scale, cuda, seed=2)
    params = [t.clone().requires_grad_() for t in (gb, bb, gs, bs)]

    def step(x, g):
        xr = x.detach().requires_grad_()
        y, mean, var = K.BNLive.apply(xr, *params, EPS, relu)
        grads = torch.autograd.grad(y, [xr, *params], g)
        return (y, mean, var, *grads)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    build.reserve_scratch(stream)
    xs, gs_in = x0.clone(), g0.clone()
    with torch.cuda.stream(stream):
        step(xs, gs_in)  # warm up outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = step(xs, gs_in)
    torch.cuda.current_stream().wait_stream(stream)
    xs.copy_(x1)
    gs_in.copy_(g1)
    graph.replay()
    want = step(x1, g1)
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b)
