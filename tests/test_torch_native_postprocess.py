"""The port's ``liver_mask_extent`` byte for byte against scipy and against
the JAX package's: the external mask's one 6-connected dilation and its z
extent, on the native core (``native/postprocess.cpp``'s
``pp_dilate_extent``, which dilates over the mask's grown bounding box) and
on the scipy fallback (``native.pp_available`` patched off)."""
from __future__ import annotations

import numpy as np
import pytest
from scipy import ndimage

from hdenseunet_tpu.infer import postprocess as j_postprocess
from hdenseunet_tpu_torch import native
from hdenseunet_tpu_torch.infer import postprocess

SHAPE = (17, 19, 23)
CASES = ["empty", "single_voxel", "face_x0", "face_x1", "face_y0", "face_y1", "face_z0",
         "face_z1", "label2_only", "blobs_far_apart_in_z", "full", "bool", "transposed"]


def _case(name):
    """An external mask: uint8 labels {0, 1, 2} unless the case says
    otherwise."""
    m = np.zeros(SHAPE, np.uint8)
    faces = {"x0": (0, slice(3, 9), slice(4, 11)), "x1": (-1, slice(3, 9), slice(4, 11)),
             "y0": (slice(2, 8), 0, slice(4, 11)), "y1": (slice(2, 8), -1, slice(4, 11)),
             "z0": (slice(2, 8), slice(3, 9), 0), "z1": (slice(2, 8), slice(3, 9), -1)}
    if name == "single_voxel":
        m[8, 9, 11] = 1
    elif name.startswith("face_"):
        m[faces[name[5:]]] = 1
        m[5, 6, 7] = 2
    elif name == "label2_only":
        m[4:10, 5:12, 6:15] = 2
    elif name == "blobs_far_apart_in_z":
        m[2:5, 3:6, 1:3] = 1
        m[11:15, 12:16, 19:21] = 1
    elif name == "full":
        m[:] = 1
    elif name in ("bool", "transposed"):
        m[3:12, 5:14, 6:16] = np.random.default_rng(5).random((9, 9, 10)) < 0.4
        m[6:9, 8:11, 9:12] = 2
        if name == "bool":
            return m.astype(bool)
        # a non-contiguous view of the same labels, (Z, Y, X) transposed back
        return np.ascontiguousarray(m.transpose(2, 1, 0)).transpose(2, 1, 0)
    return m


@pytest.mark.parametrize("route", ["native", "scipy"])
@pytest.mark.parametrize("case", CASES)
def test_liver_mask_extent_matches_scipy_and_the_original(monkeypatch, case, route):
    """Each route against scipy's ``binary_dilation`` and argwhere's z range,
    and against the JAX package's ``liver_mask_extent``; the input is left
    as it was."""
    mask = _case(case)
    assert case != "transposed" or not mask.flags.c_contiguous
    want = ndimage.binary_dilation(mask.astype(bool), iterations=1)
    idx = np.argwhere(want)
    lo, hi = (0, mask.shape[2] - 1) if idx.size == 0 else (idx[:, 2].min(), idx[:, 2].max())
    if route == "scipy":
        monkeypatch.setattr(native, "pp_available", lambda: False)
    elif not native.pp_available():
        pytest.skip("no C++ toolchain")
    before = mask.copy()
    got, got_lo, got_hi = postprocess.liver_mask_extent(mask)
    assert np.array_equal(mask, before)
    assert got.dtype == np.bool_ and got.shape == mask.shape
    assert got.tobytes() == want.tobytes() and (got_lo, got_hi) == (lo, hi)
    j_got, j_lo, j_hi = j_postprocess.liver_mask_extent(mask)
    assert got.tobytes() == j_got.astype(bool).tobytes() and (got_lo, got_hi) == (j_lo, j_hi)
