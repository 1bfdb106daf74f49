"""Native (C++) host postprocess, compiled on demand and bound with ctypes.

The port's copy of the postprocess half of hdenseunet_tpu/native/__init__.py:
``postprocess.cpp`` (a copy of the JAX package's) runs the serving CC and
morphology pipeline (test.py:70-115) as O(N) passes, byte-exact against the
scipy twins in ``infer/postprocess.py``. It is compiled with ``g++`` into
``build/native/`` at the root of the checkout, named by a hash of the source,
apart from the JAX package's cache. Without a toolchain ``pp_available()`` is
False and ``infer/postprocess.py`` takes the scipy path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

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
        return None  # unusable build location -> scipy path
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def _pp_load():
    so = _build(_PP_SRC, "postprocess")
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    L = ctypes.c_long
    PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    for fn in ("pp_largest_component", "pp_fill_holes", "pp_dilate"):
        getattr(lib, fn).argtypes = [PU8, L, L, L, PU8]
        getattr(lib, fn).restype = None
    return lib


def pp_available() -> bool:
    return _pp_load() is not None


def _pp_call(fn_name: str, mask) -> np.ndarray:
    lib = _pp_load()
    assert lib is not None, "native postprocess unavailable"
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    assert m.ndim == 3, m.shape
    out = np.empty_like(m)
    getattr(lib, fn_name)(m, *m.shape, out)
    return out


def pp_largest_component(mask):
    """Largest 26-connected component (bool). Exact scipy label+argmax twin."""
    return _pp_call("pp_largest_component", mask).astype(bool)


def pp_fill_holes(mask):
    """binary_fill_holes twin: 6-conn border flood on the complement."""
    return _pp_call("pp_fill_holes", mask).astype(bool)


def pp_dilate(mask):
    """binary_dilation(iterations=1) twin: one 6-conn cross dilation."""
    return _pp_call("pp_dilate", mask).astype(bool)
