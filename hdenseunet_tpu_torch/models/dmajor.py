"""D-major execution of the 3D branch (counterpart of
hdenseunet_tpu/models/dmajor.py).

The canonical 3D tensor of the port is (B, C, H, W, D) in
``channels_last_3d`` memory, (B, H, W, D, C). The d-major tensor is
(B, C, D, H, W) in ``channels_last_3d``, so its memory is the JAX d-major
(B, D, H, W, C): the CT depth, 2-8 in the network's middle, no longer sits
innermost among the spatial dims.

Parameters are untouched: a :class:`layers.Conv` keeps its canonical kernel
(F, Cin, kh, kw, kz) and runs it permuted to (kz, kh, kw) at forward time,
with its padding resolved per canonical axis and reordered (TF-SAME's extra
pad stays at the end of each axis), so checkpoints, the HDF5 converter and
the warm start are the canonical path's. Windows, strides and factors of the
pools and the upsample are given in the canonical (H, W, D) order, as the
JAX functions take them. The same multiply-accumulate set as the canonical
path: outputs differ by float summation order only.
"""
from __future__ import annotations

from . import layers as L

PERM = (2, 0, 1)  # the canonical axis that each d-major spatial axis holds


def _reorder(v):
    """A canonical (H, W, D) window, stride or factor in d-major order."""
    h, w, z = L.norm_tuple(v, 3)
    return (z, h, w)


def fold(x):
    """(B, C, H, W, D) -> (B, C, D, H, W), channels-last in memory."""
    return L.channels_last(x.permute(0, 1, 4, 2, 3))


def unfold(xd):
    """(B, C, D, H, W) -> (B, C, H, W, D), channels-last in memory."""
    return L.channels_last(xd.permute(0, 1, 3, 4, 2))


def conv3d(conv: L.Conv, xd):
    """``conv`` (its canonical parameters, stride and padding) on a d-major
    tensor."""
    return conv(xd, perm=PERM)


def max_pool(xd, window, stride, pad=0):
    """Zero-padded VALID max pool (layers.max_pool); window, stride and pad
    in the canonical order."""
    return L.max_pool(xd, _reorder(window), _reorder(stride), pad=_reorder(pad))


def avg_pool(xd, window, stride):
    return L.avg_pool(xd, _reorder(window), _reorder(stride))


def upsample_nearest(xd, factors):
    return L.upsample_nearest(xd, _reorder(factors))
