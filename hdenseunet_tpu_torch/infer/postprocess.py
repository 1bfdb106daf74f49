"""Threshold + connected-component postprocessing (reference test.py:70-115).

The port's copy of hdenseunet_tpu/infer/postprocess.py, driving the port's
own ``native`` build; tests hold its output byte-identical to the original.

Host-side scipy.ndimage (skimage is absent from this image; ndimage.label +
bincount replaces skimage.measure.label/regionprops and is faster — one pass
instead of per-region property objects).

Pipeline, matching the reference order exactly:
1. threshold liver prob at ``thres_liver`` (0.5), tumor at ``thres_tumor``
   (0.9); tumor pixels force liver=1 (test.py:73-77);
2. keep the largest connected component of the *predicted* liver (test.py:84-91);
3. dilate the external liver mask once more, keep ITS largest CC, fill holes
   (test.py:94-104) — note the external mask was already dilated once at load
   (test.py:60), so it is dilated twice in total;
4. tumor := tumor AND external-mask-CC, fill holes (test.py:107-108);
5. labelmap: largest-CC liver (holes filled) = 1, tumor = 2 (test.py:109-113).
"""
from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from .. import native
from ..utils.profiling import count


def _use_native(mask: np.ndarray) -> bool:
    """3D masks route to the C++ core (native/postprocess.cpp) when the
    toolchain is present: scipy's ``binary_fill_holes`` flood-fills by
    iterated dilation (O(N x diameter)) and measured 38-64 s per 512x512x192
    volume on the 1-core host — the pipelined serving floor (BENCH_NOTES.md
    "Round-5 serving-path attribution"); the native passes are O(N) and
    byte-exact (tests/test_torch_native_postprocess.py). Set
    ``HDENSEUNET_HOST_POSTPROCESS=scipy`` to force the scipy path."""
    return (
        mask.ndim == 3
        and os.environ.get("HDENSEUNET_HOST_POSTPROCESS", "") != "scipy"
        and native.pp_available()
    )


def largest_component(mask: np.ndarray) -> np.ndarray:
    """Boolean mask of the largest FULL-connectivity component (26-connected
    in 3D, 8-connected in 2D).

    The reference's ``skimage.measure.label`` (test.py:84-104) defaults to
    full connectivity (connectivity = ndim); scipy's ``ndimage.label`` default
    is orthogonal-only, so the structuring element is passed explicitly to
    match — diagonally-touching components the reference merges must merge
    here too, or the 'largest' pick can differ."""
    if _use_native(mask):
        return native.pp_largest_component(mask)
    structure = ndimage.generate_binary_structure(mask.ndim, mask.ndim)
    labels, num = ndimage.label(mask, structure=structure)
    if num == 0:
        return np.zeros_like(mask, dtype=bool)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    return labels == int(sizes.argmax())


def fill_holes(mask: np.ndarray) -> np.ndarray:
    if _use_native(mask):
        return native.pp_fill_holes(mask)
    return ndimage.binary_fill_holes(mask)


def dilate(mask: np.ndarray) -> np.ndarray:
    """One 6-conn (default-structure) binary dilation."""
    if _use_native(mask):
        return native.pp_dilate(mask)
    return ndimage.binary_dilation(mask.astype(bool), iterations=1)


def compose_labelmap(
    liver_prob: np.ndarray,
    tumor_prob: np.ndarray,
    ext_liver_mask: np.ndarray,
    *,
    thres_liver: float = 0.5,
    thres_tumor: float = 0.9,
) -> np.ndarray:
    """(liver prob, tumor prob, external mask) -> uint8 labelmap {0,1,2}."""
    liver = liver_prob >= thres_liver
    tumor = tumor_prob >= thres_tumor
    liver |= tumor  # test.py:77
    return compose_from_masks(liver, tumor, ext_liver_mask)


def compose_from_masks(
    liver: np.ndarray, tumor: np.ndarray, ext_liver_mask: np.ndarray
) -> np.ndarray:
    """Postprocess pre-thresholded masks (device-resident pipeline hands these
    over as a packed uint8: bit0 = liver|tumor, bit1 = tumor)."""
    liver = liver | tumor
    liver_cc = largest_component(liver)

    ext = dilate(ext_liver_mask.astype(bool))
    ext_cc = fill_holes(largest_component(ext))

    tumor_final = fill_holes(tumor & ext_cc)

    out = fill_holes(liver_cc).astype(np.uint8)
    out[tumor_final] = 2
    return out


def liver_mask_extent(mask: np.ndarray):
    """External mask -> (dilated mask, z_min, z_max) (reference test.py:58-63:
    binarize label-2 into the mask, dilate once, take index extent).

    Any nonzero label is set, so label 2 needs no rewrite. The native core
    dilates over the mask's nonzero bounding box grown by one voxel, zeros
    outside it; that box is the dilation's own, so its z range is the
    extent. The counter ``mask_box_voxels`` adds the box's voxels. An empty
    mask gives (all False, 0, Z - 1)."""
    if _use_native(mask):
        m, box = native.pp_dilate_extent(mask)
    else:
        m = dilate(mask != 0)
        box = _nonzero_box(m)
    x0, x1, y0, y1, z0, z1 = box
    count("mask_box_voxels", (x1 - x0) * (y1 - y0) * (z1 - z0))
    if z1 == 0:
        return m, 0, mask.shape[2] - 1
    return m, z0, z1 - 1


def _nonzero_box(m: np.ndarray):
    """A 3D mask's nonzero bounding box (x0, x1, y0, y1, z0, z1), half-open,
    from its projections; all zeros when the mask is empty."""
    box = []
    for axis in range(3):
        nz = np.flatnonzero(m.any(axis=tuple(a for a in range(3) if a != axis)))
        if nz.size == 0:
            return (0,) * 6
        box += [int(nz[0]), int(nz[-1]) + 1]
    return tuple(box)
