"""A training step's inverted dropout, forward and backward: kernel K7.

Element i of x's memory (the batch axis outermost), counted from
``offset``, is kept when the top 24 bits of ``hash32(seed mod 2^32 ^
(offset + i))`` fall below ``round(keep * 2^24)``, keep = 1 - rate
(``models/layers.hash32``; ``hdu_bench/reference/models.dropout_keep``
states the same rule); the output is ``x / keep * mask``. The backward is
autograd's of that expression, ``(g * mask) / keep``: the same operation
on g, with the mask drawn again from the seed. So ``Dropout``, the
differentiable op, saves the 0-d seed tensor and no mask.

``dropout_forward`` and ``dropout_backward`` launch the one hand-written
kernel of ``csrc/dropout.cu`` on a CUDA tensor, or raise; on a CPU tensor
(or a meta tensor, which computes nothing) they run the plain PyTorch
version, ``dropout_reference`` and ``dropout_backward_reference``: an int64
hash over every element, then the arithmetic above. There is no fallback
from the kernel to its plain version.

On the card the chain's ``/ keep`` is a multiply by the float32 reciprocal
of keep (ATen's division by a scalar), which the kernel repeats: a kept
element is x * (1 / keep) rounded once to x's dtype, a dropped one x * 0
with its sign (NaN stays NaN).

The JAX package has no counterpart kernel: XLA fuses its dropout.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import profiling
from . import build

_P, _I, _LL, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_float
_M32 = 0xFFFFFFFF
_KEEP_BITS = 24  # a mask compares the hash's top 24 bits with keep * 2^24


@functools.cache
def _lib():
    """The built library with the argument types of K7's entry point."""
    lib = build.library()
    lib.hdu_dropout.argtypes = [_P, _P, _LL, _P, _U, _U, _F, _I, _I, _P]
    return lib


def _threshold(rate: float) -> int:
    return round((1.0 - rate) * 2**_KEEP_BITS)


def _keep_mask(seed, n: int, rate: float, offset: int = 0) -> torch.Tensor:
    """(n,) bool on the seed's device: element i is kept when the top 24
    bits of hash32(seed mod 2^32 ^ (offset + i)) fall below round((1 -
    rate) 2^24)."""
    from ..models.layers import hash32

    seed = seed & _M32
    h = hash32(torch.arange(offset, offset + n, dtype=torch.int64, device=seed.device).bitwise_xor_(seed))
    return (h >> (32 - _KEEP_BITS)) < _threshold(rate)


def _mask_like(t, seed, rate, offset, stride):
    """The 0/1 mask in t's dtype, laid over memory with ``stride``."""
    kept = _keep_mask(seed, t.numel(), rate, offset)
    return kept.to(t.dtype).as_strided(t.shape, stride)


def dropout_reference(x, seed, rate: float, offset: int = 0):
    """Plain PyTorch K7 forward: ``x / keep * mask``, the mask over x's
    memory order."""
    return x / (1.0 - rate) * _mask_like(x, seed, rate, offset, x.stride())


def dropout_backward_reference(g, seed, rate: float, offset: int, stride):
    """Plain PyTorch K7 backward: autograd's ``(g * mask) / keep``, the
    mask laid over the forward's memory order (``stride``, x's)."""
    return g * _mask_like(g, seed, rate, offset, stride) / (1.0 - rate)


def _launch(name, t, seed, rate, offset, scale_first):
    """The kernel over t's memory: a new tensor with t's strides."""
    if t.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {t.dtype}")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != t.device:
        raise ValueError(f"{name}: seed must be one int64 on {t.device}")
    out = torch.empty_like(t)  # keeps t's strides
    keep = np.float32(1.0 - rate)
    inv = float(np.float32(1.0) / keep)
    build.run(_lib().hdu_dropout, name, t, t.data_ptr(), out.data_ptr(), t.numel(), seed.data_ptr(),
              offset, _threshold(rate), inv, scale_first, build.DTYPE_CODES[t.dtype])
    return out


def dropout_forward(x, seed, rate: float, offset: int = 0):
    """:func:`dropout_reference`'s output. A CPU or meta tensor takes the
    plain version; a CUDA tensor launches K7 and counts the call in
    ``dropout_forward.launches``, or raises: x float32 or bfloat16, dense
    in memory (:func:`models.layers.dropout` checks that), the seed one
    int64 on x's device."""
    if x.is_cpu or x.is_meta:
        return dropout_reference(x, seed, rate, offset)
    y = _launch("dropout_forward", x, seed, rate, offset, True)
    dropout_forward.launches += 1
    return y


dropout_forward.launches = 0


def dropout_backward(g, seed, rate: float, offset: int, stride):
    """:func:`dropout_backward_reference`'s dx, given the output gradient g
    and the forward's x strides. A CPU or meta tensor takes the plain
    version; a CUDA tensor launches K7 on g copied to x's memory order
    where it is not in it, and counts the call in
    ``dropout_backward.launches``."""
    if g.is_cpu or g.is_meta:
        return dropout_backward_reference(g, seed, rate, offset, stride)
    if any(a != b for a, b, size in zip(g.stride(), stride, g.shape) if size > 1):
        g = g.new_empty_strided(g.shape, stride).copy_(g)
    dx = _launch("dropout_backward", g, seed, rate, offset, False)
    dropout_backward.launches += 1
    return dx


dropout_backward.launches = 0


class Dropout(torch.autograd.Function):
    """Differentiable K7: ``apply(x, seed, rate, offset)`` -> x / keep *
    mask; seed a 0-d int64 tensor on x's device (``Ctx.seed``'s hash),
    offset the index of x's first element in the whole batch. Saves the
    seed alone. Each forward, a checkpoint's recompute included, counts one
    ``dropout`` on the program's recorder (``utils/profiling.count``)."""

    @staticmethod
    def forward(ctx, x, seed, rate: float, offset: int):
        profiling.count("dropout")
        ctx.save_for_backward(seed)
        ctx.rate, ctx.offset, ctx.stride = rate, offset, x.stride()
        return dropout_forward(x, seed, rate, offset)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return dropout_backward(g, seed, ctx.rate, ctx.offset, ctx.stride), None, None, None
