"""The device scorer's window accumulate and finish: kernel K3.

Counterpart of the XLA program inside hdenseunet_tpu/infer/device_pipeline.py's
jitted scoring (no Pallas body there): per window batch the fp32 softmax of
the logits, the two z-edge slices dropped, and ``score += w * p``, ``count +=
w`` per window in window order (K3a); per volume ``score / (count + 1e-4)``,
the liver and tumour thresholds to the labels {0, 1, 3}, and optionally the
2-bit wire (K3b).

- ``window_accumulate`` (K3a): adds one batch's windows into the score
  buffer and the per-z count, in place.
- ``score_finish`` (K3b): the labels (``out="labels"``, uint8 {0, 1, 3}: bit
  0 liver or tumour, bit 1 tumour) or the 2-bit wire (``out="wire"``, 4 z
  voxels a byte, the first in the low bits) over the first ``pack_z`` slices,
  without writing the average.

On a CUDA tensor each launches its hand-written kernel in ``csrc/score.cu``
and counts the call in ``fn.launches``, or raises; on a CPU tensor each runs
its plain PyTorch version (``*_reference``): ``torch.softmax``, one
``add_(alpha=w)`` and one count add per window, the divide, the thresholds
and ``ops.cc.pack2bits``. There is no fallback from a kernel to its plain
version. The kernels give the plain versions' bits on the card
(``csrc/score.cu`` says how).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .cc import pack2bits

MAX_WINDOWS = 64  # live windows a batch the kernel takes: csrc/score.cu's kMaxWindows
OUTPUTS = ("labels", "wire")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    """The built library with the argument types of K3's entry points."""
    lib = build.library()
    lib.hdu_window_accumulate.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P]
    lib.hdu_score_finish.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
    return lib


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def window_accumulate_reference(score, count, logits, starts, weights, *, cols: int):
    """Plain K3a: add each window's weighted interior probabilities (the fp32
    softmax of its logits, the two z-edge slices dropped) into ``score`` and
    its weight into ``count``, window by window; weight-0 windows add
    nothing and are skipped. score: (X, Y, zp, C) float32; count: (zp,)
    float32; logits: (wb, X, Y, cols, C); starts, weights: (wb,) host
    arrays."""
    probs = torch.softmax(logits.float(), dim=-1)
    inner = cols - 2
    for j in range(len(starts)):
        w = float(weights[j])
        if w == 0.0:
            continue
        sj = int(starts[j]) + 1
        score[:, :, sj : sj + inner].add_(probs[j, :, :, 1:-1], alpha=w)
        count[sj : sj + inner] += w


def pack_labels(score, thres_liver: float, thres_tumor: float, *, num_classes: int = 3):
    """Threshold -> uint8 mask: bit0 liver-or-tumor, bit1 tumor (test.py:73-77)."""
    liver = score[..., num_classes - 2] >= thres_liver
    tumor = score[..., num_classes - 1] >= thres_tumor
    return (liver | tumor).to(torch.uint8) + 2 * tumor.to(torch.uint8)


def score_finish_reference(score, count, thres_liver: float, thres_tumor: float, *,
                           out: str, pack_z: int | None = None):
    """Plain K3b: the average ``score / (count + 1e-4)`` (funcs.py:48), the
    thresholds to labels (:func:`pack_labels`), cropped to the first
    ``pack_z`` slices (contiguous, as the kernel writes them); ``out="wire"``
    packs them 2 bits a voxel (``ops.cc.pack2bits``)."""
    probs = score / (count[None, None, :, None] + 1e-4)
    mask = pack_labels(probs, thres_liver, thres_tumor, num_classes=score.shape[-1])
    if out == "wire":
        return pack2bits(mask, pack_z=pack_z)
    return mask if pack_z is None else mask[:, :, :pack_z].contiguous()


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_buffer(name, score, count):
    if score.dim() != 4 or not 2 <= score.shape[-1] <= 4 or count.shape != (score.shape[2],):
        raise ValueError(
            f"{name}: score (X, Y, zp, C in 2..4) and count (zp,), got "
            f"{tuple(score.shape)} and {tuple(count.shape)}"
        )
    if count.device != score.device:
        raise ValueError(f"{name}: score and count lie on different devices")
    if not score.is_cpu:
        if not score.is_cuda:
            raise ValueError(f"{name}: unsupported device {score.device}")
        if score.dtype != torch.float32 or count.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32 score and count, got {score.dtype}, {count.dtype}")
        if not score.is_contiguous() or not count.is_contiguous():
            raise ValueError(f"{name}: kernel takes a contiguous score buffer and count")


def window_accumulate(score, count, logits, starts, weights, *, cols: int):
    """Add one window batch into the score buffer and count, in place
    (arguments as in :func:`window_accumulate_reference`). Every window
    with a nonzero weight must lie inside the buffer: 0 <= start and start +
    cols <= zp. A CPU tensor takes the plain version; CUDA tensors launch
    K3a (one kernel, float32 or bfloat16 logits read through their strides)
    when any weight is nonzero and count the call in
    ``window_accumulate.launches``, or raise."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    weights = np.asarray(weights, np.float32).reshape(-1)
    _check_buffer("window_accumulate", score, count)
    x, y, zp, c = score.shape
    wb = len(starts)
    if logits.shape != (wb, x, y, cols, c) or len(weights) != wb:
        raise ValueError(
            f"window_accumulate: logits {tuple(logits.shape)}, {wb} starts and {len(weights)} "
            f"weights do not fit a ({x}, {y}, {zp}, {c}) buffer and {cols} columns"
        )
    live = np.flatnonzero(weights != 0.0)
    outside = [int(s) for s in starts[live] if s < 0 or s + cols > zp]
    if outside:
        raise ValueError(f"window_accumulate: windows at {outside} reach outside the {zp} slices")
    if score.is_cpu:
        return window_accumulate_reference(score, count, logits, starts, weights, cols=cols)
    if logits.device != score.device or logits.dtype not in build.DTYPE_CODES:
        raise ValueError(f"window_accumulate: logits {logits.dtype} on {logits.device}")
    if len(live) > MAX_WINDOWS:
        raise ValueError(f"window_accumulate: {len(live)} live windows, the kernel takes {MAX_WINDOWS}")
    if not len(live):
        return
    strides = (ctypes.c_longlong * 5)(*logits.stride())
    index = (ctypes.c_int * len(live))(*live.tolist())
    at = (ctypes.c_int * len(live))(*starts[live].tolist())
    w = (ctypes.c_float * len(live))(*weights[live].tolist())
    build.run(_lib().hdu_window_accumulate, "window_accumulate", score,
              score.data_ptr(), count.data_ptr(), logits.data_ptr(), build.DTYPE_CODES[logits.dtype],
              x, y, zp, c, cols, strides, len(live), index, at, w)
    window_accumulate.launches += 1


window_accumulate.launches = 0


def score_finish(score, count, thres_liver: float, thres_tumor: float, *,
                 out: str, pack_z: int | None = None):
    """uint8 labels (X, Y, pack_z) or, with ``out="wire"``, the 2-bit wire
    (X, Y, pack_z / 4) of the averaged, thresholded score buffer; ``pack_z``
    (default zp) crops z first. A CPU tensor takes
    :func:`score_finish_reference`; CUDA tensors launch K3b (one kernel)
    and count the call in ``score_finish.launches``, or raise."""
    if out not in OUTPUTS:
        raise ValueError(f"score_finish: out must be one of {OUTPUTS}, got {out!r}")
    _check_buffer("score_finish", score, count)
    x, y, zp, c = score.shape
    z = zp if pack_z is None else pack_z
    if not 0 < z <= zp or (out == "wire" and z % 4):
        raise ValueError(f"score_finish: pack_z {pack_z} for {zp} slices and out={out!r}")
    if score.is_cpu:
        return score_finish_reference(score, count, thres_liver, thres_tumor, out=out, pack_z=pack_z)
    wire = out == "wire"
    result = torch.empty((x, y, z // 4 if wire else z), dtype=torch.uint8, device=score.device)
    build.run(_lib().hdu_score_finish, "score_finish", score,
              score.data_ptr(), count.data_ptr(), result.data_ptr(), x, y, zp, c, z, int(wire),
              thres_liver, thres_tumor)
    score_finish.launches += 1
    return result


score_finish.launches = 0
