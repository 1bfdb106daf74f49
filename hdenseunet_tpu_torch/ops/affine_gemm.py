"""The dense blocks' 1x1 convolution with its BN∘Scale∘ReLU folded in: kernel K5.

The serving path runs every frozen BN∘Scale∘ReLU in front of a 1x1 (or
1x1x1) convolution, and often another behind it:

    y = relu(conv1x1(relu(x*A1 + B1), W)*A2 + B2)

The JAX package leaves this chain to XLA, which fuses the folded affine and
ReLU into the neighbouring convolutions (hdenseunet_tpu/ops/fused_affine.py
:13-18); K5 is the port's counterpart of that fusion, one GEMM with K1's
arithmetic as its prologue and, when asked for, as its epilogue
(``csrc/affine_gemm.cu``). A 1x1 convolution on channels-last memory is a
product of the (rows, K) activation with the (N, K) kernel, the same in
every layout of the 3D branch. The activation may be the first K channels of
a wider buffer (rows of stride ``ld``), read in place: the dense block's
concatenation is never copied (``models/layers.dense_block``).

On a CUDA tensor :func:`affine_gemm` launches K5 or raises; on a CPU or meta
tensor it runs :func:`affine_gemm_reference`, the unfused chain op for op
(``affine_relu_reference``, ``F.conv2d``/``F.conv3d``,
``affine_relu_reference``). There is no fallback from the kernel to its
plain version. K5 has no backward: training and any forward that records
a gradient keep K1, cuDNN and the concatenation (``layers.fused_1x1``), and
on a CUDA tensor :func:`affine_gemm` raises rather than return a result
that cuts the graph.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .fused_affine import affine_relu_reference, _f32_vector

_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}


def affine_gemm_reference(x, w, scale, shift, scale2=None, shift2=None):
    """Plain PyTorch K5: ``affine_relu_reference(x)``, the 1x1 convolution
    by ``w`` (N, K), then ``affine_relu_reference`` by (scale2, shift2) when
    given: the unfused chain of the models, op for op. x: (B, K, *S), 4-d
    or 5-d, channels on axis 1; returns (B, N, *S) channels-last."""
    fmt = _FORMATS[x.dim()]
    h = affine_relu_reference(x, scale, shift).contiguous(memory_format=fmt)
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    y = conv(h, w.view(*w.shape, *[1] * (x.dim() - 2))).contiguous(memory_format=fmt)
    if scale2 is not None:
        y = affine_relu_reference(y, scale2, shift2)
    return y


def float64_reference(x, w, scale, shift, scale2=None, shift2=None, *, fused: bool = True):
    """The yardstick of a K5 result on the card: (y, bound), each (rows, N)
    float64. y is the chain with the product in float64 over K5's own
    operand (K1's one fused multiply-add, exact in float64 for bfloat16
    inputs, rounded once to float32 and then to x's dtype) and the epilogue
    in float64. bound is how far a result may lie from y: one ulp of x's
    dtype for rounding the product, ``K`` float32 ulps of ``sum |h||w|``
    for summing it in float32, both carried through the epilogue by
    ``|scale2|``, and one ulp of the epilogue's rounding. ``fused=False``
    adds one ulp of each operand for a prologue that rounds x*A and x*A + B
    apart (the plain version's two roundings)."""
    k, n = x.shape[1], w.shape[0]
    xr = x.movedim(1, -1).reshape(-1, k).double()
    a = scale.to(x.dtype).double().to(x.device)
    b = shift.to(x.dtype).double().to(x.device)
    h = torch.relu((xr * a + b).float()).to(x.dtype).double()
    wd = w.double()
    y = h @ wd.T
    s = h.abs() @ wd.abs().T
    eps, tiny = torch.finfo(x.dtype).eps, torch.finfo(x.dtype).tiny
    bound = eps * y.abs() + k * 2.0**-23 * s + tiny
    if not fused:
        bound += eps * s
    if scale2 is not None:
        a2 = scale2.to(x.dtype).double().to(x.device)
        b2 = shift2.to(x.dtype).double().to(x.device)
        y = torch.relu(y * a2 + b2)
        bound = a2.abs() * bound + eps * y.abs() + tiny
    return y, bound


def row_stride(x) -> int | None:
    """The row stride ``ld`` of x (B, K, *S) seen as (rows, K) rows in
    memory: channels contiguous and every other axis, innermost spatial
    first, a whole number of rows of ``ld`` elements, ``ld >= K``. None when
    x is not laid out so."""
    k = x.shape[1]
    if k > 1 and x.stride(1) != 1:
        return None
    ld, expect = None, None
    for d in [*range(x.dim() - 1, 1, -1), 0]:  # innermost spatial axis first, batch last
        if x.shape[d] == 1:
            continue
        if expect is None:
            ld = expect = x.stride(d)
        elif x.stride(d) != expect:
            return None
        expect *= x.shape[d]
    ld = k if ld is None else ld
    return ld if ld >= k else None


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = build.library()
    lib.hdu_affine_gemm.argtypes = [_P, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]
    lib.hdu_affine_gemm_form.argtypes = [_LL, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_LL)]
    lib.hdu_affine_gemm_form.restype = None
    return lib


def form(rows: int, n: int, dtype) -> dict:
    """The launch :func:`affine_gemm` makes on the card for ``rows`` rows,
    N ``n`` and ``dtype``: ``tile_n``, the output tile's width (0 for the
    float32 tiling), and ``blocks``, the grid (the bfloat16 form is
    persistent: at most one block an SM). Needs the built library."""
    bn, blocks = _I(), _LL()
    _lib().hdu_affine_gemm_form(rows, n, build.DTYPE_CODES[dtype], ctypes.byref(bn), ctypes.byref(blocks))
    return dict(tile_n=bn.value, blocks=blocks.value)


def _aligned(v, x):
    """v as a contiguous float32 vector on x's device, 8-byte aligned (the
    kernel reads A1 and B1 two at a time)."""
    v = _f32_vector(v, x)
    return v if v.data_ptr() % 8 == 0 else v.clone()


def affine_gemm(x, w, scale, shift, scale2=None, shift2=None):
    """``relu(conv1x1(relu(x*scale + shift), w)*scale2 + shift2)``, the
    outer affine+ReLU only when scale2 and shift2 are given.

    x: (B, K, *S) float32 or bfloat16 (4-d or 5-d), channels on axis 1, laid
    out as rows of K channels at one row stride (:func:`row_stride`), e.g.
    a channel prefix of a channels-last buffer; w: (N, K) in x's dtype;
    scale, shift: (K,) and scale2, shift2: (N,) float (the folded pairs of
    ``fold_bn_scale``), rounded to x's dtype as K1 rounds them. Returns (B,
    N, *S) channels-last contiguous. A CPU or meta tensor takes
    :func:`affine_gemm_reference`; a CUDA tensor launches K5 and counts the
    launch in ``affine_gemm.launches``, or raises. bfloat16 needs K and N
    multiples of 8, a row stride a multiple of 8 and x and w 16-byte
    aligned.
    """
    if (scale2 is None) != (shift2 is None):
        raise ValueError("affine_gemm: scale2 and shift2 come together")
    if x.is_cpu or x.is_meta:
        return affine_gemm_reference(x, w, scale, shift, scale2, shift2)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, shift, scale2, shift2)):
        raise RuntimeError("affine_gemm: K5 has no backward; run it under no_grad or inference_mode, "
                           "or take the unfused route")
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"affine_gemm: x and w must share a CUDA device, got {x.device}, {w.device}")
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"affine_gemm: kernel takes float32 or bfloat16 x and w alike, got "
                        f"{x.dtype}, {w.dtype}")
    if (x.dim() not in _FORMATS or w.dim() != 2 or w.shape[1] != x.shape[1] or x.shape[1] == 0
            or not w.is_contiguous()):
        raise ValueError(f"affine_gemm: x (B, K, *S) 4-d or 5-d and w (N, K) contiguous, K > 0, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k, n = x.shape[1], w.shape[0]
    if scale.shape != (k,) or shift.shape != (k,) or (
            scale2 is not None and (scale2.shape != (n,) or shift2.shape != (n,))):
        raise ValueError(f"affine_gemm: scale/shift must be ({k},), scale2/shift2 ({n},)")
    ld = row_stride(x)
    if ld is None:
        raise ValueError(f"affine_gemm: x must be rows of its channels at one stride, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype == torch.bfloat16 and (
            k % 8 or n % 8 or ld % 8 or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"affine_gemm: bfloat16 needs K, N and the row stride multiples of 8 and "
                         f"16-byte aligned x and w, got K {k}, N {n}, ld {ld}")
    y = torch.empty((x.shape[0], n, *x.shape[2:]), dtype=x.dtype, device=x.device,
                    memory_format=_FORMATS[x.dim()])
    if y.numel() == 0:
        return y
    rows = x.numel() // k
    a1, b1 = _aligned(scale, x), _aligned(shift, x)
    a2, b2 = (None, None) if scale2 is None else (_f32_vector(scale2, x), _f32_vector(shift2, x))
    build.run(
        _lib().hdu_affine_gemm, "affine_gemm", x,
        x.data_ptr(), ld, w.data_ptr(), a1.data_ptr(), b1.data_ptr(),
        None if a2 is None else a2.data_ptr(), None if b2 is None else b2.data_ptr(),
        y.data_ptr(), rows, k, n, build.DTYPE_CODES[x.dtype],
    )
    affine_gemm.launches += 1
    return y


affine_gemm.launches = 0
