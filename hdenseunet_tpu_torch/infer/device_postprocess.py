"""Device-resident postprocess: the reference's CC pipeline on the card
(counterpart of hdenseunet_tpu/infer/device_postprocess.py).

The host postprocess (test.py:70-115; ``infer/postprocess.py`` with
``native/postprocess.cpp``) thresholds, keeps the largest 26-connected
component of the predicted liver, dilates the external liver mask once more,
keeps its largest component and fills its holes, gates the tumour by it and
fills holes again. Here the same pipeline runs on the scorer's device, on
the K4 kernels of ``ops/cc.py``, so the host only receives the final
labelmap. Every step is integer or boolean and bit-identical to scipy's
(tests/test_torch_device_postprocess.py).

Crop and padding: the serving pipeline applies the compose to the z-cropped,
xy-padded score buffer instead of the whole volume. That is exact for the
reasons the JAX module gives (device_postprocess.py:33-41): every nonzero
voxel of every intermediate lies inside the crop, the xy padding is zeroed,
and a zero margin, or the true volume border, keeps both the component
structure and the border-connectivity of the background.

Not ported: the chunked fixpoint loops (``propagate_min_chunked`` and the
``*_chunked`` forms). They bound the length of one XLA dispatch because a
relay killed long dispatches; a union-find kernel has no fixpoint loop to
bound. ``InferConfig.postprocess_chunk_iters`` is accepted by the scorer and
does not change the output: the JAX package's chunked forms reach the same
fixpoint, byte for byte (tests/test_device_postprocess.py:114-150).
"""
from __future__ import annotations

import torch

from ..ops import cc
from ..ops.cc import fill_holes, largest_component  # K4c, K4b

# ``ndimage.binary_dilation`` with its default cross structure, once: plain
# PyTorch on any device, because the serving path dilates inside
# ``compose_prep``'s kernel and only compose_labels calls this
dilate_cross = cc.dilate_cross_reference


def _postprocess(liver, tumor, ext):
    """(hole-filled largest liver component, final tumour) from liver or
    tumour, tumour and the twice-dilated external mask (test.py:84-113)."""
    liver_cc = largest_component(liver)
    ext_cc = fill_holes(largest_component(ext))
    tumor_final = fill_holes(tumor & ext_cc)
    return fill_holes(liver_cc), tumor_final


def compose_labels(liver, tumor, ext_mask):
    """Device twin of ``postprocess.compose_from_masks``: bool (X, Y, Z)
    inputs, the once-dilated external mask among them -> uint8 labelmap
    {0 bg, 1 liver, 2 tumour}."""
    liver_filled, tumor_final = _postprocess(liver | tumor, tumor, dilate_cross(ext_mask))
    return torch.where(tumor_final, 2, liver_filled.to(torch.uint8)).to(torch.uint8)


def _compose(packed_scores, ext_bits, pack_z: int):
    liver, tumor, ext = cc.compose_prep(packed_scores, ext_bits, pack_z=pack_z)
    return cc.compose_finish(*_postprocess(liver, tumor, ext))


def compose_packed(packed_scores, ext_bits, *, pack_z: int):
    """Thresholded score mask + packed external mask -> the final labelmap's
    2-bit wire (Xp, Yp, pack_z/4), the shape ``labelmask_collect`` reads.

    packed_scores: uint8 (Xp, Yp, Zp) {0, 1, 3}; ext_bits: the external
    mask's z-crop, ``np.packbits``'d along z, (X0, Y0, pack_z/8)."""
    return _compose(packed_scores, ext_bits, pack_z)[1]


def compose_final(packed_scores, ext_bits, *, pack_z: int):
    """Like :func:`compose_packed`, but keeps the labelmap on the device:
    (uint8 (Xp, Yp, pack_z), inclusive nonzero bbox int32[6] (x_lo, x_hi,
    y_lo, y_hi, z_lo, z_hi)) for the sparse bbox wire; an empty map has
    lo > hi."""
    labels, _, bbox = _compose(packed_scores, ext_bits, pack_z)
    return labels, bbox
