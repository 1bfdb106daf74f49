"""Native (C++) host cores, compiled on demand and bound with ctypes.

The port's copy of hdenseunet_tpu/native/__init__.py, for two hot loops the
reference leaves to python libraries:

* ``sampler.cpp`` — the training sampler's crop, mean subtraction, flip/rot
  augmentation and per-slice resize (Catmull-Rom cubic for images, nearest
  for labels, cv2's INTER_CUBIC/INTER_NEAREST arithmetic) as one C call;
* ``postprocess.cpp`` — the serving CC and morphology pipeline
  (test.py:70-115) as O(N) passes, byte-exact against the scipy twins in
  ``infer/postprocess.py``.

Both sources are copies of the JAX package's, except that the port's
dilation, ``pp_dilate_extent``, runs over the mask's grown bounding box
(the tests hold its output to scipy's and the original's). Each is compiled
with ``g++`` into ``build/native/`` at the root of the checkout, named by a
hash of the source, apart from the JAX package's cache. ctypes releases the
GIL for the length of each call, so crop threads run in parallel.

Without a toolchain ``available()`` / ``pp_available()`` are False. The
postprocess then takes its scipy path; the sampler has no other route to
the 'cv2' resize family and refuses to run (``data/sampler.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "sampler.cpp"
_PP_SRC = Path(__file__).parent / "postprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _build(src: Path, stem: str) -> Path | None:
    """Compile one .cpp -> cached .so keyed by source hash, or None."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{tag}.so"
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None  # unusable build location -> no native core
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def _load():
    so = _build(_SRC, "sampler")
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    L = ctypes.c_long
    F = ctypes.c_float
    I = ctypes.c_int
    PF = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    PS = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.crop_aug_resize.argtypes = [PF, PS, L, L, L, L, L, L, L, L, L, F, I, L, PF, PS]
    lib.crop_aug_resize.restype = None
    lib.crop_aug.argtypes = [PF, PS, L, L, L, L, L, L, L, L, L, F, I, PF, PS]
    lib.crop_aug.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def _checked(vol, seg, origin, size):
    """Contiguous float32/int16 copies of vol and seg, the origin and size
    as ints, after checking that the crop lies inside the volume."""
    vol = np.ascontiguousarray(vol, np.float32)
    seg = np.ascontiguousarray(seg, np.int16)
    origin = tuple(int(v) for v in origin)
    size = tuple(int(v) for v in size)
    if vol.ndim != 3 or seg.shape != vol.shape:
        raise ValueError(f"vol {vol.shape} and seg {seg.shape} must be one (X, Y, Z) shape")
    if any(o < 0 or s < 1 or o + s > n for o, s, n in zip(origin, size, vol.shape)):
        raise ValueError(f"crop at {origin} of size {size} leaves the volume {vol.shape}")
    return vol, seg, origin, size


def crop_aug_resize(vol, seg, origin, size, *, mean, flip_case, out_size):
    """Fused crop+augment+resize. vol (X,Y,Z) f32 C-order; seg int16.

    Returns (image (out,out,cols) float32 mean-subtracted, labels int16).
    """
    lib = _load()
    assert lib is not None, "native sampler unavailable"
    vol, seg, (a, b, c), (deps, rows, cols) = _checked(vol, seg, origin, size)
    out_img = np.empty((out_size, out_size, cols), np.float32)
    out_seg = np.empty((out_size, out_size, cols), np.int16)
    lib.crop_aug_resize(
        vol, seg, *vol.shape, a, b, c, deps, rows, cols,
        float(mean), int(flip_case), int(out_size), out_img, out_seg,
    )
    return out_img, out_seg


def crop_aug(vol, seg, origin, size, *, mean, flip_case):
    """Crop + flip/rot only (exact numpy-semantics oracle pair)."""
    lib = _load()
    assert lib is not None, "native sampler unavailable"
    vol, seg, (a, b, c), (deps, rows, cols) = _checked(vol, seg, origin, size)
    h2, w2 = (rows, deps) if 3 <= flip_case <= 6 else (deps, rows)
    out_img = np.empty((h2, w2, cols), np.float32)
    out_seg = np.empty((h2, w2, cols), np.int16)
    lib.crop_aug(
        vol, seg, *vol.shape, a, b, c, deps, rows, cols,
        float(mean), int(flip_case), out_img, out_seg,
    )
    return out_img, out_seg


@functools.cache
def _pp_load():
    so = _build(_PP_SRC, "postprocess")
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    L = ctypes.c_long
    PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    for fn in ("pp_largest_component", "pp_fill_holes"):
        getattr(lib, fn).argtypes = [PU8, L, L, L, PU8]
        getattr(lib, fn).restype = None
    PL = np.ctypeslib.ndpointer(ctypes.c_long, shape=(6,), flags="C_CONTIGUOUS")
    lib.pp_dilate_extent.argtypes = [PU8, L, L, L, PU8, PL]
    lib.pp_dilate_extent.restype = None
    return lib


def pp_available() -> bool:
    return _pp_load() is not None


def _mask_bytes(mask) -> np.ndarray:
    """A 3D mask as the C-contiguous uint8 bytes the core reads (any nonzero
    byte is set): a bool or uint8 mask's own memory where it is already
    C-contiguous, else a copy."""
    m = np.asarray(mask)
    if m.dtype != np.bool_ and m.dtype != np.uint8:
        m = m != 0
    m = np.ascontiguousarray(m)
    if m.ndim != 3:
        raise ValueError(f"the native postprocess takes (X, Y, Z) masks, not {m.shape}")
    return m.view(np.uint8)


def _pp_call(fn_name: str, mask) -> np.ndarray:
    lib = _pp_load()
    assert lib is not None, "native postprocess unavailable"
    m = _mask_bytes(mask)
    out = np.empty(m.shape, bool)  # the core writes 0/1 into its bytes
    getattr(lib, fn_name)(m, *m.shape, out.view(np.uint8))
    return out


def pp_largest_component(mask):
    """Largest 26-connected component (bool). Exact scipy label+argmax twin."""
    return _pp_call("pp_largest_component", mask)


def pp_fill_holes(mask):
    """binary_fill_holes twin: 6-conn border flood on the complement."""
    return _pp_call("pp_fill_holes", mask)


def pp_dilate_extent(mask):
    """binary_dilation(iterations=1) twin, computed over the mask's nonzero
    bounding box grown by one voxel: (the bool dilation, that box as
    (x0, x1, y0, y1, z0, z1) half-open, all zeros for an empty mask). The
    box is the dilation's nonzero box, so its z range is the z extent."""
    lib = _pp_load()
    assert lib is not None, "native postprocess unavailable"
    m = _mask_bytes(mask)
    out = np.zeros(m.shape, bool)  # untouched pages stay unallocated
    box = np.zeros(6, ctypes.c_long)
    lib.pp_dilate_extent(m, *m.shape, out.view(np.uint8), box)
    return out, tuple(int(v) for v in box)


def pp_dilate(mask):
    """binary_dilation(iterations=1) twin: one 6-conn cross dilation."""
    return pp_dilate_extent(mask)[0]
