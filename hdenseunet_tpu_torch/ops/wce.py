"""Masked, class-weighted cross-entropy: kernel K2 (counterpart of
hdenseunet_tpu/ops/wce.py).

    loss = -sum_i m_i * w[y_i] * max(log p_i[y_i], ln 1e-10)  /  sum_i m_i

over N rows of C <= 8 logits, with an inclusion mask m (all ones for the 2D
stage; the z-boundary mask for the hybrid stages, train/loss.py). The
backward is the closed form of the JAX custom VJP (wce.py:129-142):

    dlogits_i = g * m_i * w[y_i] * live_i * (softmax_i - onehot(y_i)) / sum m,

where live_i = [log p_i[y_i] > ln 1e-10] (the clip kills the gradient).

``weighted_ce`` is the differentiable op (``WeightedCE``). Its forward
``wce_forward`` and backward ``wce_backward`` launch the hand-written kernels
of ``csrc/wce.cu`` on a CUDA tensor, or raise; on a CPU tensor they run the
plain PyTorch versions ``weighted_ce_reference`` and
``weighted_ce_backward_reference``. There is no fallback from a kernel to its
plain version.

Over a batch split across ranks (``group``), the loss is the global batch's:
each rank's forward gives its rows' (loss, sum of the mask), one all-reduce
sums (loss * sum, sum) over the ranks, and the backward takes the global sum
of the mask, so each rank's dlogits is its rows' share of the global loss's
gradient. The kernels are the same.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from . import build

LOG_CLIP = -23.025850929940457  # ln(1e-10), wce.py:27
MAX_CLASSES = 8
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    """The built library with the argument types of K2's entry points."""
    lib = build.library()
    lib.hdu_wce_fwd.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _P, _P]
    lib.hdu_wce_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
    return lib


def _log_softmax(logits2):
    """float32 log-softmax over the last axis, max-subtracted (wce.py:38-46)."""
    x = logits2.float()
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - shifted.exp().sum(dim=-1, keepdim=True).log()


def weighted_ce_reference(logits2, labels1, mask1, weights):
    """Plain PyTorch K2 forward -> (loss, sum of the mask), float32 scalars.

    logits2: (N, C); labels1: (N,) integer in [0, C); mask1: (N,);
    weights: (C,) float32 tensor.
    """
    labels = labels1.long()
    logp = _log_softmax(logits2).clamp_min(LOG_CLIP)
    picked = logp.gather(1, labels[:, None])[:, 0]
    m = mask1.float()
    s = (m * weights.float()[labels] * picked).sum()
    cnt = m.sum()
    return -s / cnt, cnt


def weighted_ce_backward_reference(logits2, labels1, mask1, weights, cnt, g):
    """Plain PyTorch K2 backward (wce.py:129-142) -> dlogits in the logits'
    dtype. cnt is the forward's sum of the mask, g the loss's gradient."""
    labels = labels1.long()
    logp = _log_softmax(logits2)
    onehot = torch.nn.functional.one_hot(labels, logits2.shape[-1]).float()
    picked = logp.gather(1, labels[:, None])[:, 0]
    live = (picked > LOG_CLIP).float()
    coeff = (mask1.float() * weights.float()[labels] * live / cnt)[:, None]
    return (g.float() * coeff * (logp.exp() - onehot)).to(logits2.dtype)


def _check(logits2, labels1, mask1, weights):
    if not logits2.is_cuda:
        raise ValueError(f"weighted_ce: unsupported device {logits2.device}")
    if logits2.dtype not in build.DTYPE_CODES:
        raise TypeError(f"weighted_ce: kernel takes float32 or bfloat16 logits, got {logits2.dtype}")
    if logits2.dim() != 2 or not logits2.is_contiguous():
        raise ValueError(f"weighted_ce: logits must be a contiguous (N, C) matrix, got {logits2.shape}")
    n, c = logits2.shape
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"weighted_ce: the kernel takes 1 to {MAX_CLASSES} classes, got {c}")
    for name, t, dtype, shape in (
        ("labels", labels1, torch.int32, (n,)),
        ("mask", mask1, torch.float32, (n,)),
        ("weights", weights, torch.float32, (c,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"weighted_ce: {name} must be a contiguous {dtype} {shape}")
        if t.device != logits2.device:
            raise ValueError(f"weighted_ce: {name} is on {t.device}, logits on {logits2.device}")


def wce_forward(logits2, labels1, mask1, weights):
    """(loss, sum of the mask) as float32 scalars; arguments as in
    :func:`weighted_ce_reference`. A CPU tensor takes the plain version. A
    CUDA tensor launches K2's forward, one kernel, and counts the launch in
    ``wce_forward.launches``, or raises: labels int32, mask and weights
    float32, all contiguous."""
    if logits2.is_cpu:
        return weighted_ce_reference(logits2, labels1, mask1, weights)
    _check(logits2, labels1, mask1, weights)
    n, c = logits2.shape
    if n == 0:
        raise ValueError("weighted_ce: no rows")
    out = torch.empty((2,), dtype=torch.float32, device=logits2.device)
    build.run(
        _lib().hdu_wce_fwd, "wce_forward", logits2,
        logits2.data_ptr(), labels1.data_ptr(), mask1.data_ptr(), weights.data_ptr(),
        out.data_ptr(), n, c, build.DTYPE_CODES[logits2.dtype], scratch=True,
    )
    wce_forward.launches += 1
    return out[0], out[1]


wce_forward.launches = 0


def wce_backward(logits2, labels1, mask1, weights, cnt, g):
    """dlogits in the logits' dtype; cnt and g are float32 scalars on the
    logits' device (no host round trip). A CPU tensor takes the plain
    version; a CUDA tensor launches K2's backward and counts the launch in
    ``wce_backward.launches``, or raises."""
    if logits2.is_cpu:
        return weighted_ce_backward_reference(logits2, labels1, mask1, weights, cnt, g)
    _check(logits2, labels1, mask1, weights)
    cnt = cnt.to(torch.float32).contiguous()
    g = g.to(device=logits2.device, dtype=torch.float32).contiguous()
    if cnt.numel() != 1 or g.numel() != 1 or cnt.device != logits2.device:
        raise ValueError("wce_backward: cnt and g must be scalars on the logits' device")
    n, c = logits2.shape
    dlogits = torch.empty_like(logits2)
    build.run(
        _lib().hdu_wce_bwd, "wce_backward", logits2,
        logits2.data_ptr(), labels1.data_ptr(), mask1.data_ptr(), weights.data_ptr(),
        cnt.data_ptr(), g.data_ptr(), dlogits.data_ptr(), n, c,
        build.DTYPE_CODES[logits2.dtype],
    )
    wce_backward.launches += 1
    return dlogits


wce_backward.launches = 0


class WeightedCE(torch.autograd.Function):
    """The custom VJP ``weighted_ce`` of wce.py:108-145: forward
    :func:`wce_forward`, backward :func:`wce_backward`; labels, mask and
    weights take no gradient. With a process ``group`` the loss and the sum
    of the mask are the global batch's (module docstring)."""

    @staticmethod
    def forward(ctx, logits2, labels1, mask1, weights, group=None):
        loss, cnt = wce_forward(logits2, labels1, mask1, weights)
        if group is not None:
            sums = torch.stack([loss * cnt, cnt])
            dist.all_reduce(sums, group=group)
            loss, cnt = sums[0] / sums[1], sums[1]
        ctx.save_for_backward(logits2, labels1, mask1, weights, cnt)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels1, mask1, weights, cnt = ctx.saved_tensors
        return wce_backward(logits2, labels1, mask1, weights, cnt, g), None, None, None, None


def weighted_ce(logits2, labels1, mask1, weights, group=None):
    """Masked weighted CE over flat (N, C) logits; differentiable in the
    logits. weights: a sequence of C floats or a float32 tensor (pass a
    tensor already on the logits' device to spare a copy per call).
    ``group``: the process group whose ranks hold the other rows of the
    batch, or None."""
    weights = torch.as_tensor(weights, dtype=torch.float32, device=logits2.device)
    return WeightedCE.apply(logits2, labels1, mask1, weights, group)
