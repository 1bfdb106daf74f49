"""Fused per-channel affine (+ReLU) for frozen BN∘Scale∘ReLU: kernel K1.

Counterpart of hdenseunet_tpu/ops/fused_affine.py. With frozen statistics,
BatchNormalization followed by the Caffe-style Scale is one per-channel
affine, and the ReLU after it is a clamp:

    relu((x*a1 + b1)*a2 + b2)  ==  relu(x*A + B),  A = a1*a2, B = b1*a2 + b2

``AffineReLU`` is the differentiable op, the counterpart of the JAX custom
VJP ``_affine_relu_2d``: its forward is ``affine_relu`` and its backward
``affine_relu_backward``. On a CUDA tensor each launches its hand-written
kernel in ``csrc/fused_affine.cu`` or raises; on a CPU tensor (or a meta
tensor, which computes nothing) each runs its plain PyTorch version (``affine_relu_reference``,
``affine_relu_backward_reference``). There is no fallback from a kernel to
its plain version.

The backward keeps ``y`` from the forward, as JAX does (fused_affine.py:78),
for the ReLU mask: it reads g, x and y and writes dx, 8 bytes per bf16
element. Recomputing the mask from x*A+B would read 6, but y is alive anyway
as the input the next convolution keeps for its own backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build



def fold_bn_scale(gamma_bn, beta_bn, mean, var, gamma_s, beta_s, eps):
    """Fold frozen-BN + Scale into one per-channel (A, B) pair (float32)."""
    inv = torch.rsqrt(var.float() + eps) * gamma_bn.float()
    b1 = beta_bn.float() - mean.float() * inv
    a = inv * gamma_s.float()
    b = b1 * gamma_s.float() + beta_s.float()
    return a, b


def _channel_view_shape(x):
    shape = [1] * x.dim()
    shape[1] = -1
    return shape


def affine_relu_reference(x, scale, shift, *, relu: bool = True):
    """Plain PyTorch K1: ``relu(x*scale + shift)`` over channel axis 1.

    scale and shift are rounded to x.dtype (as the JAX function does), then
    the arithmetic is float32 and the result is rounded once to x.dtype.
    """
    shape = _channel_view_shape(x)
    a = scale.to(x.dtype).float().view(shape)
    b = shift.to(x.dtype).float().view(shape)
    y = x.float() * a + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def rows_contiguous(x) -> bool:
    """True when x, with channels on axis 1, is channels-last contiguous,
    i.e. its memory is a (rows, C) matrix."""
    if x.dim() == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    if x.dim() == 5:
        return x.is_contiguous(memory_format=torch.channels_last_3d)
    return x.dim() >= 2 and x.movedim(1, -1).is_contiguous()


def vector_path(x, *others) -> bool:
    """Whether the kernels take their 16-byte vector path, by the rule their
    entry points apply (csrc/fused_affine.cu): C a multiple of the vector
    width and every pointer 16-byte aligned."""
    vec = 16 // x.element_size()
    return x.shape[1] % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others))


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    """The built library with the argument types of K1's entry points."""
    lib = build.library()
    lib.hdu_affine_relu.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _P]
    lib.hdu_affine_relu_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P]
    return lib


def _check_cuda(name, x):
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    if not rows_contiguous(x):
        raise ValueError(
            f"{name}: kernel needs a channels-last contiguous tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}"
        )


def _f32_vector(v, x):
    """v as a contiguous float32 vector on x's device: v itself when it is one."""
    if v.dtype == torch.float32 and v.is_contiguous() and v.get_device() == x.get_device():
        return v
    return v.to(device=x.device, dtype=torch.float32).contiguous()


def affine_relu(x, scale, shift, *, relu: bool = True):
    """relu(x * scale + shift) per channel; channels on axis 1.

    x: (N, C, ...) float32 or bfloat16, channels-last contiguous on CUDA;
    scale, shift: (C,) float (the folded pair of :func:`fold_bn_scale`).
    A CPU tensor takes :func:`affine_relu_reference`, and so does a meta
    tensor, which computes nothing (``utils/flops.py`` counts FLOPs on the
    meta device). A CUDA tensor launches K1 and counts the launch in
    ``affine_relu.launches``, or raises. The
    kernel rounds scale and shift to x.dtype as it reads them, so float32
    vectors on x's device reach it without a copy.
    """
    if x.is_cpu or x.is_meta:
        return affine_relu_reference(x, scale, shift, relu=relu)
    _check_cuda("affine_relu", x)
    c = x.shape[1]
    if scale.shape != (c,) or shift.shape != (c,):
        raise ValueError(f"affine_relu: scale/shift must be ({c},)")
    a, b = _f32_vector(scale, x), _f32_vector(shift, x)
    y = torch.empty_like(x)  # keeps x's channels-last strides
    if x.numel() == 0:
        return y
    build.run(
        _lib().hdu_affine_relu, "affine_relu", x,
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        x.numel() // c, c, build.DTYPE_CODES[x.dtype], relu,
    )
    affine_relu.launches += 1
    return y


affine_relu.launches = 0


def affine_relu_backward_reference(g, x, scale, y, *, relu: bool = True):
    """Plain PyTorch K1 backward (fused_affine.py:81-89), channels on axis 1.

    g is masked by ``y > 0`` (relu only); ``dx = g * scale`` in x.dtype with
    scale rounded to x.dtype; ``dscale = sum g*x`` and ``dshift = sum g`` over
    every axis but 1 in float32, rounded to x.dtype and returned as float32.
    """
    shape = _channel_view_shape(x)
    if relu:
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    dx = (g.float() * scale.to(x.dtype).float().view(shape)).to(x.dtype)
    dims = [d for d in range(x.dim()) if d != 1]
    gf = g.float()
    dscale = (gf * x.float()).sum(dims).to(x.dtype).float()
    dshift = gf.sum(dims).to(x.dtype).float()
    return dx, dscale, dshift


def affine_relu_backward(g, x, scale, y, *, relu: bool = True):
    """(dx, dscale, dshift) of ``affine_relu(x, scale, shift, relu=relu)``
    given the output gradient g and the forward's output y (read only when
    relu is set).

    g, x, y share a shape and dtype, channels on axis 1. A CPU or meta
    tensor takes :func:`affine_relu_backward_reference`. A CUDA tensor launches K1's
    backward, one kernel, and counts the launch in
    ``affine_relu_backward.launches``, or raises: g, x and y must then be
    channels-last contiguous on one device.
    """
    if x.is_cpu or x.is_meta:
        return affine_relu_backward_reference(g, x, scale, y, relu=relu)
    _check_cuda("affine_relu_backward", x)
    for name, t in (("g", g), ("y", y)) if relu else (("g", g),):
        if (t.shape != x.shape or t.dtype != x.dtype or t.get_device() != x.get_device()
                or not rows_contiguous(t)):
            raise ValueError(
                f"affine_relu_backward: {name} must match x in shape, dtype and device, "
                "channels-last contiguous"
            )
    c = x.shape[1]
    if scale.shape != (c,):
        raise ValueError(f"affine_relu_backward: scale must be ({c},)")
    a = _f32_vector(scale, x)
    dx = torch.empty_like(x)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)  # dscale, dshift
    rows = x.numel() // c
    if rows == 0:
        return (dx, *grads.zero_())
    build.run(
        _lib().hdu_affine_relu_bwd, "affine_relu_backward", x,
        g.data_ptr(), x.data_ptr(), y.data_ptr() if relu else None, a.data_ptr(),
        dx.data_ptr(), grads.data_ptr(), rows, c, build.DTYPE_CODES[x.dtype], relu,
        scratch=True,
    )
    affine_relu_backward.launches += 1
    return (dx, *grads)


affine_relu_backward.launches = 0


def _like_rows(g, x):
    """g in x's memory format: channels-last contiguous, as the kernel reads."""
    if rows_contiguous(g):
        return g
    return g.movedim(1, -1).contiguous().movedim(-1, 1)


class AffineReLU(torch.autograd.Function):
    """Differentiable ``relu(x * scale + shift)`` (the JAX custom VJP
    ``_affine_relu_2d``): forward :func:`affine_relu`, backward
    :func:`affine_relu_backward`, which returns float32 gradients for the
    float32 scale and shift, rounded to x.dtype as JAX's are."""

    @staticmethod
    def forward(ctx, x, scale, shift, relu: bool = True):
        y = affine_relu(x, scale, shift, relu=relu)
        ctx.relu = relu
        ctx.save_for_backward(x, scale, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, y = ctx.saved_tensors
        dx, dscale, dshift = affine_relu_backward(_like_rows(g, x), x, scale, y, relu=ctx.relu)
        return dx, dscale, dshift, None
