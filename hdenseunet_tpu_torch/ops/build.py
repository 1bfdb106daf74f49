"""Build the port's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles each in seconds (a source that includes
PyTorch's headers takes minutes). One ``nvcc`` per source runs at once, then
one links the objects. The library lands in ``build/`` at the root
of the checkout, named by a hash of the sources and flags, so an unchanged
tree reuses it and a changed one rebuilds. It is loaded with ``ctypes``; each
wrapper declares the argument types of the functions it calls once, and
calls one through :func:`run`, which raises when a launch returns an error.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype argument
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libhdu_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless it exists. Returns (path, seconds spent)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = []
    try:
        for src, obj in zip(sources, objects):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"{src.name} ({p.returncode}):\n{log[-4000:]}"
              for src, p, log in zip(sources, procs, logs) if p.returncode != 0]
    tmp = so.with_name(f"{stem}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True, timeout=300,
        )
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("\n".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    lib.hdu_error_string.argtypes = [ctypes.c_int]
    lib.hdu_error_string.restype = ctypes.c_char_p
    lib.hdu_scratch_bytes.argtypes = []
    lib.hdu_scratch_bytes.restype = ctypes.c_longlong
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed: {library().hdu_error_string(rc).decode()}")


# (device index, raw stream) -> (buffer, its address): csrc/common.cuh
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _scratch(index: int, stream: int) -> int:
    """Address of the kernels' scratch buffer for one device and stream:
    ``hdu_scratch_bytes()`` bytes, zeroed when made. Each launch that takes a
    last-block ticket leaves its counters at zero again, so the buffer is
    made once and no call needs a memset; one per stream, because launches
    that share it must not overlap."""
    found = _SCRATCH.get((index, stream))
    if found is None:
        buf = torch.zeros(library().hdu_scratch_bytes(), dtype=torch.uint8,
                          device=torch.device("cuda", index))
        found = _SCRATCH[(index, stream)] = (buf, buf.data_ptr())
    return found[1]


def reserve_scratch(stream: torch.cuda.Stream) -> None:
    """Make ``stream``'s scratch buffer now, before a CUDA graph is
    captured on ``stream``: made inside the capture, it would come from the
    graph's pool."""
    _scratch(stream.device.index, stream.cuda_stream)


def run(entry, what: str, t: torch.Tensor, *args, scratch: bool = False) -> None:
    """``entry(*args[, scratch], stream)`` on CUDA tensor t's device and its
    current stream; raise if the launch returns an error. With ``scratch``
    the entry point also gets that stream's scratch buffer. The device is
    made current only when it is not already."""
    index = t.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return run(entry, what, t, *args, scratch=scratch)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if scratch:
        args = (*args, _scratch(index, stream))
    check(entry(*args, stream), what)
