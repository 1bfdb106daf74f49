"""Live-statistics BatchNorm∘[Scale]∘[ReLU] of a training forward: kernel K6.

A training step's live BatchNorm normalises with the batch's per-channel
mean and biased variance, and is followed by the Caffe-style Scale and a
ReLU in front of every encoder conv (``models/layers.bn_scale_relu``), or by
the ReLU alone in the decoders and the head (``layers.bn_relu``). Once the
statistics are known the chain is one per-channel affine:

    y = [relu](x*A + B),  inv = 1/sqrt(var + eps),
    A = inv*gamma_bn [*gamma_s],  B = (beta_bn - mean*inv*gamma_bn) [*gamma_s + beta_s]

computed in float32 and rounded once to x's dtype. Its backward, with
g' = g*[x*A + B > 0] (relu only), xh = (x - mean)*inv, S1 = sum g' and
S2 = sum g'*xh over every axis but channels, N rows:

    dx = c1*g' + c0 + c2*(x - mean),  c1 = gamma_bn*gamma_s*inv,
    c0 = -c1*S1/N,  c2 = -c1*S2*inv/N  (the gradient through the statistics),
    dgamma_bn = gamma_s*S2, dbeta_bn = gamma_s*S1,
    dgamma_s = gamma_bn*S2 + beta_bn*S1, dbeta_s = S1

(gamma_s = 1 without a Scale), all float32. ``BNLive`` is the
differentiable op; its forward ``bn_live_forward`` and backward
``bn_live_backward`` launch the hand-written kernels of ``csrc/bn_live.cu``
(two each) on a CUDA tensor, or raise; on a CPU tensor (or a meta tensor,
which computes nothing) they run the plain PyTorch versions
``bn_live_reference`` and ``bn_live_backward_reference``, which repeat the
kernels' arithmetic in float32 (float64 for float64). There is no fallback
from a kernel to its plain version.

Given a process ``group`` of several ranks, each holding its rows of the
global batch, the statistics and dx's S1 and S2 are the global batch's:
each side merges this rank's per-channel sums across ranks between its
reduction and its apply (:func:`merge_moments`, :func:`merge_sums`: one
all-reduce each, the same in the kernels' path and the plain one), and the
parameters' gradients stay this rank's share, which the trainer's gradient
all-reduce adds. Every rank then holds the same statistics bit for bit.

The JAX package has no counterpart kernel: XLA fuses its live BN.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from ..utils import profiling
from . import build
from .fused_affine import _check_cuda, _f32_vector, _like_rows

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _lib():
    """The built library with the argument types of K6's entry points."""
    lib = build.library()
    lib.hdu_bn_live_forward.argtypes = [_I, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P, _LL, _I, _I,
                                        _P, _P]
    lib.hdu_bn_live_backward.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _I,
                                         _I, _P, _P]
    return lib


def _dims(x):
    return [d for d in range(x.dim()) if d != 1]


def _view(v, x):
    shape = [1] * x.dim()
    shape[1] = -1
    return v.view(shape)


def _work_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _rows(x):
    return x.numel() // x.shape[1]


def _gather(local, rows: int, group):
    """(ranks, local.numel() + 1) float64, the same on every rank of
    ``group``: row r holds rank r's ``local`` flattened, then its row count.
    One all-reduce of a buffer in which each rank fills only its own row: a
    sum of one value and zeros is exact."""
    buf = torch.zeros((dist.get_world_size(group), local.numel() + 1), dtype=torch.float64,
                      device=local.device)
    mine = buf[dist.get_rank(group)]
    mine[:-1] = local.reshape(-1)
    mine[-1] = rows
    dist.all_reduce(buf, group=group)
    return buf


def fold_moments(stacked):
    """(2C + 1,) float64: the global mean, biased variance and row count
    of ranks' (mean, var, rows) rows, ``stacked`` (ranks, 2C + 1) as
    :func:`_gather` gives them, with N = sum n_r, mean = sum n_r mean_r / N
    and var = sum n_r (var_r + (mean_r - mean)^2) / N."""
    c = (stacked.shape[1] - 1) // 2
    n, means = stacked[:, -1:], stacked[:, :c]
    total = n.sum(0)
    mean = (n * means).sum(0) / total
    dev = means - mean
    var = (n * (stacked[:, c:2 * c] + dev * dev)).sum(0) / total
    return torch.cat([mean, var, total])


def merge_moments(moments, rows: int, group):
    """This rank's (2, C) mean and biased variance over its ``rows`` rows
    -> the global batch's over every rank of ``group``, with the global row
    count: (2C + 1,) float64, the same bits on every rank."""
    return fold_moments(_gather(moments, rows, group))


def merge_sums(sums, rows: int, group):
    """This rank's (2, C) S1 and S2 over its ``rows`` rows -> their sums
    over every rank of ``group``, then the global row count: (2C + 1,)
    float64, the same bits on every rank."""
    return _gather(sums, rows, group).sum(0)


def bn_live_reference(x, gamma_bn, beta_bn, gamma_s=None, beta_s=None, *, eps: float,
                      relu: bool, group=None):
    """Plain PyTorch K6 forward -> (y, mean, var, coef), channels on axis 1.

    mean and biased var over every axis but 1 (``torch.var_mean``), or
    under ``group`` those of the global batch (:func:`merge_moments`);
    coef stacks (inv, A, B), each (C,); y = [relu](x*A + B) rounded once to
    x.dtype. All in float32 (float64 for float64)."""
    wd = _work_dtype(x)
    xf = x.to(wd)
    var, mean = torch.var_mean(xf, dim=_dims(x), correction=0)
    if group is not None:
        c = x.shape[1]
        merged = merge_moments(torch.stack([mean, var]), _rows(x), group).to(wd)
        mean, var = merged[:c], merged[c:2 * c]
    inv = torch.rsqrt(var + eps)
    a = inv * gamma_bn.to(wd)
    b = beta_bn.to(wd) - mean * a
    if gamma_s is not None:
        b = b * gamma_s.to(wd) + beta_s.to(wd)
        a = a * gamma_s.to(wd)
    y = xf * _view(a, x) + _view(b, x)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, var, torch.stack([inv, a, b])


def bn_live_forward(x, gamma_bn, beta_bn, gamma_s=None, beta_s=None, *, eps: float,
                    relu: bool, group=None):
    """(y, mean, var, coef) of :func:`bn_live_reference`.

    A CPU or meta tensor takes the plain version. A CUDA tensor launches
    K6's statistics and apply kernels and counts the call in
    ``bn_live_forward.launches``, or raises: x float32 or bfloat16,
    channels-last contiguous (its memory a (rows, C) matrix), with rows;
    the parameters (C,) vectors, cast to contiguous float32 on x's device.
    Under ``group`` the statistics kernel's moments are merged across
    ranks before the apply."""
    if x.is_cpu or x.is_meta:
        return bn_live_reference(x, gamma_bn, beta_bn, gamma_s, beta_s, eps=eps, relu=relu,
                                 group=group)
    _check_cuda("bn_live_forward", x)
    c = x.shape[1]
    rows = x.numel() // c if c else 0
    if rows == 0:
        raise ValueError(f"bn_live_forward: no rows to take statistics over, shape {tuple(x.shape)}")
    gbn, bbn = _f32(gamma_bn, x, c), _f32(beta_bn, x, c)
    gs, bs = (None, None) if gamma_s is None else (_f32(gamma_s, x, c), _f32(beta_s, x, c))
    y = torch.empty_like(x)  # keeps x's channels-last strides
    stats = torch.empty((5, c), dtype=torch.float32, device=x.device)  # mean, var, inv, A, B

    def launch(phase, moments=None):
        build.run(
            _lib().hdu_bn_live_forward, "bn_live_forward", x, phase,
            x.data_ptr(), gbn.data_ptr(), bbn.data_ptr(), _ptr(gs), _ptr(bs), eps, relu,
            y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
            _ptr(moments), rows, c, build.DTYPE_CODES[x.dtype], scratch=True,
        )

    if group is None:
        launch(0)
    else:
        moments = torch.empty((2, c), dtype=torch.float64, device=x.device)
        launch(1, moments)
        launch(2, merge_moments(moments, rows, group))
    bn_live_forward.launches += 1
    return y, stats[0], stats[1], stats[2:]


bn_live_forward.launches = 0


def bn_live_backward_reference(g, x, mean, coef, gamma_bn, beta_bn, gamma_s=None, *,
                               relu: bool, group=None):
    """Plain PyTorch K6 backward -> (dx, grads): dx in x.dtype; grads
    (4, C) stacks dgamma_bn, dbeta_bn, dgamma_s, dbeta_s (the last two
    zero without a Scale), in float32 (float64 for float64). Under
    ``group`` dx takes the global batch's S1, S2 and row count
    (:func:`merge_sums`) and grads are this rank's share."""
    wd = _work_dtype(x)
    xf, gf = x.to(wd), g.to(wd)
    inv, a, b = coef
    if relu:
        gf = torch.where(xf * _view(a, x) + _view(b, x) > 0, gf, gf.new_zeros(()))
    d = xf - _view(mean, x)
    s1 = gf.sum(_dims(x))
    s2 = (gf * (d * _view(inv, x))).sum(_dims(x))
    n, t1, t2 = _rows(x), s1, s2
    if group is not None:
        c = x.shape[1]
        merged = merge_sums(torch.stack([s1, s2]), n, group).to(wd)
        t1, t2, n = merged[:c], merged[c:2 * c], merged[2 * c]
    gbn = gamma_bn.to(wd)
    gs = torch.ones_like(gbn) if gamma_s is None else gamma_s.to(wd)
    c1 = gbn * gs * inv
    c0, c2 = -c1 * t1 / n, -c1 * t2 * inv / n
    dx = _view(c1, x) * gf + _view(c0, x) + _view(c2, x) * d
    if gamma_s is None:
        grads = torch.stack([s2, s1, torch.zeros_like(s1), torch.zeros_like(s1)])
    else:
        grads = torch.stack([gs * s2, gs * s1, gbn * s2 + beta_bn.to(wd) * s1, s1])
    return dx.to(x.dtype), grads


def bn_live_backward(g, x, mean, coef, gamma_bn, beta_bn, gamma_s=None, *, relu: bool,
                     group=None):
    """(dx, grads) of :func:`bn_live_backward_reference`, given the output
    gradient g and the forward's x, mean and coef.

    A CPU or meta tensor takes the plain version. A CUDA tensor launches
    K6's reduction and apply kernels and counts the call in
    ``bn_live_backward.launches``, or raises: g and x must then share a
    shape, dtype and device, channels-last contiguous. Under ``group`` the
    reduction's S1 and S2 are merged across ranks before the apply."""
    if x.is_cpu or x.is_meta:
        return bn_live_backward_reference(g, x, mean, coef, gamma_bn, beta_bn, gamma_s, relu=relu,
                                          group=group)
    _check_cuda("bn_live_backward", x)
    if g.shape != x.shape or g.dtype != x.dtype or g.get_device() != x.get_device():
        raise ValueError("bn_live_backward: g must match x in shape, dtype and device")
    _check_cuda("bn_live_backward", g)
    c = x.shape[1]
    rows = x.numel() // c
    gbn, bbn = _f32(gamma_bn, x, c), _f32(beta_bn, x, c)
    gs = None if gamma_s is None else _f32(gamma_s, x, c)
    mean, coef = _f32(mean, x, c), coef.contiguous()
    dx = torch.empty_like(x)
    out = torch.empty((7, c), dtype=torch.float32, device=x.device)  # grads (4), dx's coefficients (3)

    def launch(phase, sums=None, merged=None):
        build.run(
            _lib().hdu_bn_live_backward, "bn_live_backward", x, phase,
            g.data_ptr(), x.data_ptr(), mean.data_ptr(), coef.data_ptr(), gbn.data_ptr(),
            bbn.data_ptr(), _ptr(gs), relu, dx.data_ptr(), out[0].data_ptr(), out[4].data_ptr(),
            _ptr(sums), _ptr(merged), rows, c, build.DTYPE_CODES[x.dtype], scratch=True,
        )

    if group is None:
        launch(0)
    else:
        sums = torch.empty((2, c), dtype=torch.float64, device=x.device)
        launch(1, sums)
        launch(2, sums, merge_sums(sums, rows, group))
    bn_live_backward.launches += 1
    return dx, out[:4]


bn_live_backward.launches = 0


def _f32(v, x, c):
    """v, a (C,) vector, as contiguous float32 on x's device."""
    if v.shape != (c,):
        raise ValueError(f"bn_live: parameters must be ({c},), got {tuple(v.shape)}")
    return _f32_vector(v, x)


def _ptr(v):
    return None if v is None else v.data_ptr()


class BNLive(torch.autograd.Function):
    """Differentiable K6: ``apply(x, gamma_bn, beta_bn, gamma_s, beta_s,
    eps, relu, group)`` -> (y, mean, var), gamma_s and beta_s None without
    a Scale, group None on one rank; mean and var (the batch's, for the
    moving statistics) carry no gradient. Each forward, a checkpoint's
    recompute included, counts one ``bn_live`` on the program's recorder
    (``utils/profiling.count``)."""

    @staticmethod
    def forward(ctx, x, gamma_bn, beta_bn, gamma_s, beta_s, eps: float, relu: bool, group=None):
        profiling.count("bn_live")
        y, mean, var, coef = bn_live_forward(x, gamma_bn, beta_bn, gamma_s, beta_s, eps=eps,
                                             relu=relu, group=group)
        ctx.relu, ctx.group = relu, group
        ctx.save_for_backward(x, mean, coef, gamma_bn, beta_bn, gamma_s)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, mean, coef, gamma_bn, beta_bn, gamma_s = ctx.saved_tensors
        dx, grads = bn_live_backward(
            _like_rows(g, x), x, mean, coef, gamma_bn, beta_bn, gamma_s, relu=ctx.relu,
            group=ctx.group)
        scaled = gamma_s is not None
        return (dx, grads[0], grads[1], grads[2] if scaled else None, grads[3] if scaled else None,
                None, None, None)
