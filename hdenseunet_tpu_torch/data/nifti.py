"""Minimal, dependency-free NIfTI-1 volume IO (numpy only).

The reference reads/writes LiTS ``.nii`` CT volumes through ``medpy.io``
(backed by nibabel/ITK), e.g. preprocessing.py:14, test.py:54, test.py:114.
Neither medpy nor nibabel ships in this image, and the subset of NIfTI-1 the
LiTS pipeline needs is small and well-specified (https://nifti.nimh.nih.gov/
nifti-1), so the framework carries its own reader/writer:

* single-file ``.nii`` and gzipped ``.nii.gz``;
* dims 3 (anything higher with trailing size-1 dims is squeezed);
* every standard datacode (int8/16/32/64, uint8/16/32/64, float32/64);
* scl_slope/scl_inter intensity scaling applied on read (like nibabel's
  ``get_fdata``) when they are set and non-identity;
* affine/header passthrough: :func:`read` returns a :class:`NiftiHeader`
  that :func:`write` can take back so output labelmaps keep the source
  geometry (the reference passes ``img_test_header`` through the same way,
  test.py:114).

Arrays are x-major (Fortran voxel order flattened per the NIfTI spec), giving
the same (x, y, z) index convention as medpy.load in the reference samplers.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

_HDR_SIZE = 348
_MAGIC_OK = (b"n+1\x00", b"ni1\x00")

# NIfTI datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiHeader:
    """The subset of the 348-byte NIfTI-1 header the pipeline preserves."""

    dim: tuple
    dtype: np.dtype
    pixdim: tuple
    scl_slope: float
    scl_inter: float
    qform_code: int
    sform_code: int
    quatern: tuple  # (b, c, d, x, y, z)
    srows: tuple  # 3 rows of 4 floats
    xyzt_units: int
    endian: str  # '<' or '>'

    @classmethod
    def identity(cls, shape, dtype=np.float32, pixdim=(1.0, 1.0, 1.0)):
        dim = tuple(shape)
        return cls(
            dim=dim,
            dtype=np.dtype(dtype),
            pixdim=tuple(float(p) for p in pixdim),
            scl_slope=0.0,
            scl_inter=0.0,
            qform_code=0,
            sform_code=1,
            quatern=(0.0,) * 6,
            srows=(
                (pixdim[0], 0.0, 0.0, 0.0),
                (0.0, pixdim[1], 0.0, 0.0),
                (0.0, 0.0, pixdim[2], 0.0),
            ),
            xyzt_units=10,  # mm | sec
            endian="<",
        )


def _open(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read(path) -> tuple[np.ndarray, NiftiHeader]:
    """Load a .nii / .nii.gz file -> (volume array (x,y,z[,…]), header)."""
    path = Path(path)
    with _open(path, "rb") as f:
        raw = f.read()

    hdr = raw[:_HDR_SIZE]
    for endian in ("<", ">"):
        (sizeof_hdr,) = struct.unpack(endian + "i", hdr[0:4])
        if sizeof_hdr == _HDR_SIZE:
            break
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr != 348)")
    magic = hdr[344:348]
    if magic not in _MAGIC_OK:
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(endian + "8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack(endian + "h", hdr[70:72])
    (bitpix,) = struct.unpack(endian + "h", hdr[72:74])
    pixdim = struct.unpack(endian + "8f", hdr[76:108])
    (vox_offset,) = struct.unpack(endian + "f", hdr[108:112])
    scl_slope, scl_inter = struct.unpack(endian + "2f", hdr[112:120])
    (xyzt_units,) = struct.unpack(endian + "b", hdr[123:124])
    qform_code, sform_code = struct.unpack(endian + "2h", hdr[252:256])
    quatern = struct.unpack(endian + "6f", hdr[256:280])
    srow = struct.unpack(endian + "12f", hdr[280:328])

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    assert dt.itemsize * 8 == bitpix, (dt, bitpix)

    n = int(np.prod(shape)) if shape else 0
    off = int(vox_offset) if vox_offset >= _HDR_SIZE else _HDR_SIZE
    data = np.frombuffer(raw, dtype=dt, count=n, offset=off)
    # NIfTI voxel order: x fastest -> Fortran order over (x, y, z, ...)
    vol = data.reshape(shape, order="F")
    vol = np.asarray(vol, dtype=vol.dtype.newbyteorder("="))

    # squeeze trailing singleton dims (common dim=[4, X, Y, Z, 1, ...])
    while vol.ndim > 3 and vol.shape[-1] == 1:
        vol = vol[..., 0]

    if scl_slope not in (0.0, 1.0) or (scl_slope != 0.0 and scl_inter != 0.0):
        vol = vol.astype(np.float32) * scl_slope + scl_inter

    header = NiftiHeader(
        dim=tuple(vol.shape),
        dtype=np.dtype(_DTYPES[datatype]),
        pixdim=tuple(float(p) for p in pixdim[1 : 1 + max(vol.ndim, 3)]),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        quatern=tuple(float(q) for q in quatern),
        srows=(tuple(srow[0:4]), tuple(srow[4:8]), tuple(srow[8:12])),
        xyzt_units=int(xyzt_units),
        endian=endian,
    )
    return vol, header


def write(path, vol: np.ndarray, header: NiftiHeader | None = None) -> None:
    """Write (x,y,z) volume as single-file NIfTI-1 (.nii or .nii.gz)."""
    path = Path(path)
    vol = np.asarray(vol)
    if header is None:
        header = NiftiHeader.identity(vol.shape, vol.dtype)
    if np.dtype(vol.dtype) not in _CODES:
        raise ValueError(f"unsupported dtype for NIfTI write: {vol.dtype}")

    e = "<"
    ndim = vol.ndim
    dim = [ndim] + list(vol.shape) + [1] * (7 - ndim)
    pixdim = [0.0] + list(header.pixdim[:ndim]) + [1.0] * (7 - ndim)
    code = _CODES[np.dtype(vol.dtype)]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into(e + "i", hdr, 0, _HDR_SIZE)
    struct.pack_into(e + "8h", hdr, 40, *dim)
    struct.pack_into(e + "h", hdr, 70, code)
    struct.pack_into(e + "h", hdr, 72, vol.dtype.itemsize * 8)
    struct.pack_into(e + "8f", hdr, 76, *pixdim)
    struct.pack_into(e + "f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into(e + "2f", hdr, 112, 0.0, 0.0)  # scl: identity on write
    struct.pack_into(e + "b", hdr, 123, header.xyzt_units)
    struct.pack_into(e + "2h", hdr, 252, header.qform_code, header.sform_code)
    struct.pack_into(e + "6f", hdr, 256, *header.quatern)
    flat_srows = [v for row in header.srows for v in row]
    struct.pack_into(e + "12f", hdr, 280, *flat_srows)
    hdr[344:348] = b"n+1\x00"

    body = np.asarray(vol, order="F").tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")  # pad to vox_offset 352
        f.write(body)
