"""Fused per-channel affine (+ReLU) for frozen BN∘Scale∘ReLU: kernel K1.

Counterpart of hdenseunet_tpu/ops/fused_affine.py. At inference every
BatchNormalization uses frozen statistics, so BN followed by the Caffe-style
Scale is one per-channel affine, and the ReLU after it is a clamp:

    relu((x*a1 + b1)*a2 + b2)  ==  relu(x*A + B),  A = a1*a2, B = b1*a2 + b2

``affine_relu`` applies it. On a CUDA tensor it launches the hand-written
kernel in ``csrc/fused_affine.cu`` (one pass over the activation) or raises;
on a CPU tensor it runs the plain PyTorch version ``affine_relu_reference``.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    return x.dim() >= 2 and x.movedim(1, -1).is_contiguous()


def vector_path(x, y, a, b) -> bool:
    """Whether the 16-byte vector path may run: C a multiple of the vector
    width and every pointer 16-byte aligned (csrc/fused_affine.cu)."""
    vec = 16 // x.element_size()
    return x.shape[1] % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, a, b))


@functools.cache
def _kernel():
    lib = build.library()
    fn = lib.hdu_affine_relu
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.hdu_error_string.argtypes = [ctypes.c_int]
    lib.hdu_error_string.restype = ctypes.c_char_p
    return fn, lib.hdu_error_string


def affine_relu(x, scale, shift, *, relu: bool = True):
    """relu(x * scale + shift) per channel; channels on axis 1.

    x: (N, C, ...) float32 or bfloat16, channels-last contiguous on CUDA;
    scale, shift: (C,) float (the folded pair of :func:`fold_bn_scale`).
    A CPU tensor takes :func:`affine_relu_reference`. A CUDA tensor launches
    K1 and counts the launch in ``affine_relu.launches``, or raises. The
    kernel rounds scale and shift to x.dtype as it reads them, so float32
    vectors on x's device reach it without a copy.
    """
    if x.device.type == "cpu":
        return affine_relu_reference(x, scale, shift, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"affine_relu: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"affine_relu: kernel takes float32 or bfloat16, got {x.dtype}")
    if not rows_contiguous(x):
        raise ValueError(
            f"affine_relu: kernel needs a channels-last contiguous tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}"
        )
    c = x.shape[1]
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise ValueError(f"affine_relu: scale/shift must be ({c},)")
    a = scale.to(device=x.device, dtype=torch.float32).contiguous()
    b = shift.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)  # keeps x's channels-last strides
    if x.numel() == 0:
        return y
    fn, error_string = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.numel() // c, c, _DTYPE_CODES[x.dtype], int(relu),
            int(vector_path(x, y, a, b)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"affine_relu: kernel launch failed: {error_string(rc).decode()}")
    affine_relu.launches += 1
    return y


affine_relu.launches = 0
