"""Connected components and compose passes of the device postprocess: K4.

Counterpart of the XLA programs in hdenseunet_tpu/infer/device_postprocess.py
(no Pallas body there). Volumes are bool (X, Y, Z) in C order, flat index
(x*Y + y)*Z + z, z fastest: scipy's raster order, on which the tie rule of
the largest component rests.

- ``cc_label`` (K4a): per voxel the smallest flat index of its component,
  26- or 6-connected; ``SENT`` outside the mask.
- ``largest_component`` (K4b): the largest 26-connected component, the
  raster-first one on a tie (scipy's ``argmax(bincount)``).
- ``fill_holes`` (K4c): ``ndimage.binary_fill_holes`` with its default
  6-connected structure.
- ``compose_prep`` / ``compose_finish`` (K4d): the elementwise ends of the
  compose (packed scores and packed external mask in; labelmap, its 2-bit
  wire and its nonzero bbox out).

On a CUDA tensor each launches its hand-written kernels in ``csrc/cc.cu``
and counts the call in ``fn.launches``, or raises; on a CPU tensor each runs
its plain PyTorch version (``*_reference``), which follows the JAX algorithm
step for step: min-label propagation with two pointer jumps per round, the
neighbourhood minimum as shifted ``torch.minimum`` along each axis (exact on
int32), ``bincount`` for the sizes and the +N seed offset for the hole fill.
There is no fallback from a kernel to its plain version.

The kernels of K4a-c label in two levels: one block labels a ``BRICK`` of
voxels in shared memory, then only voxels on brick faces hook across bricks
in global memory; K4b and K4c reduce each brick piece's count or border flag
at its local root, and a pass over the local roots alone carries them to
the component's root before one pass over every voxel writes the result
(``csrc/cc.cu`` has the design and what bounds it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SENT = 2**31 - 1  # "not a label": outside the labelled set (JAX's _SENT)
BRICK = (8, 16, 64)  # the kernels' brick (X, Y, Z): csrc/cc.cu's kBrickX, kBrickY, kBrickZ
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    """The built library with the argument types of K4's entry points."""
    lib = build.library()
    lib.hdu_cc_label.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.hdu_cc_largest.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
    lib.hdu_cc_fill.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
    lib.hdu_compose_prep.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.hdu_compose_finish.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
    return lib


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _window(t, dim: int, fill, op):
    """op of t with its two neighbours along dim; ``fill`` past the ends."""
    n = t.shape[dim]
    edge = torch.full_like(t.narrow(dim, 0, 1), fill)
    before = torch.cat([edge, t.narrow(dim, 0, n - 1)], dim)
    after = torch.cat([t.narrow(dim, 1, n - 1), edge], dim)
    return op(t, op(before, after))


def _neighbor_min(ids, conn: int):
    """Min over the 3x3x3 box (conn 26) or the 6-cross (conn 6), centre
    included, SENT outside the array: JAX's _neighbor_min_full / _cross."""
    if conn == 26:
        for dim in range(3):
            ids = _window(ids, dim, SENT, torch.minimum)
        return ids
    a, b, c = (_window(ids, dim, SENT, torch.minimum) for dim in range(3))
    return torch.minimum(torch.minimum(a, b), c)


def _propagate_min(seed, mask, conn: int, table_copies: int):
    """JAX's _propagate_min: rounds of neighbourhood minimum and two pointer
    jumps until a round changes nothing. With ``table_copies=2`` ids may be
    offset by +N and are folded back before they index."""
    n = mask.numel()

    def jump(ids):
        idx = torch.where(mask, ids, 0).reshape(-1)
        if table_copies == 2:
            idx = torch.where(idx >= n, idx - n, idx)
        j = ids.reshape(-1)[idx.long()].reshape(ids.shape)
        return torch.where(mask, torch.minimum(ids, j), SENT)

    ids = seed
    while True:
        new = torch.where(mask, torch.minimum(ids, _neighbor_min(ids, conn)), SENT)
        new = jump(jump(new))
        if torch.equal(new, ids):
            return new
        ids = new


def _flat_index(shape, device):
    return torch.arange(int(torch.Size(shape).numel()), dtype=torch.int32, device=device).reshape(shape)


def _check_size(mask, copies: int = 1):
    if copies * mask.numel() >= 2**31 - 1:
        raise ValueError(f"{copies} x {mask.numel()} voxels do not fit int32 labels")


def cc_label_reference(mask, conn: int = 26):
    """Plain K4a: int32 (X, Y, Z), the smallest flat index of each voxel's
    component (JAX's connected_min_labels for conn 26), SENT outside."""
    _check_size(mask)
    seed = torch.where(mask, _flat_index(mask.shape, mask.device), SENT)
    return _propagate_min(seed, mask, conn, table_copies=1)


def largest_component_reference(mask):
    """Plain K4b: component sizes by ``bincount`` over the min labels; the
    first maximum is the smallest root, i.e. the raster-first component."""
    labels = cc_label_reference(mask, 26)
    if not bool(mask.any()):
        return torch.zeros_like(mask)
    best = int(torch.argmax(torch.bincount(labels[mask].long())))
    return mask & (labels == best)


def _border(shape, device):
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    for dim in range(3):
        out.narrow(dim, 0, 1).fill_(True)
        out.narrow(dim, shape[dim] - 1, 1).fill_(True)
    return out


def fill_labels_reference(mask):
    """(background, converged ids) of the plain hole fill: background voxels
    seeded with their flat index on the border and flat index + N inside,
    min-propagated over the 6-connected background (JAX's _fill_seed and
    _propagate_min). A component touches the border iff its id is < N."""
    _check_size(mask, copies=2)
    n = mask.numel()
    bg = ~mask
    flat = _flat_index(mask.shape, mask.device)
    seed = torch.where(bg & _border(mask.shape, mask.device), flat, torch.where(bg, flat + n, SENT))
    return bg, _propagate_min(seed, bg, 6, table_copies=2)


def fill_holes_reference(mask):
    """Plain K4c: ``mask | (background & id >= N)`` (JAX's _fill_finish)."""
    bg, ids = fill_labels_reference(mask)
    return mask | (bg & (ids >= mask.numel()))


def dilate_cross_reference(mask):
    """``ndimage.binary_dilation`` with its default cross structure, once."""
    a, b, c = (_window(mask, dim, False, torch.logical_or) for dim in range(3))
    return a | b | c


def unpack_bits_z(buf, z: int):
    """(X, Y, q) uint8 -> (X, Y, z) bool, most significant bit first
    (``np.packbits`` along z)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=buf.device)
    bits = torch.bitwise_right_shift(buf[..., None], shifts) & 1
    x, y, q, _ = bits.shape
    return bits.reshape(x, y, q * 8)[:, :, :z].bool()


def compose_prep_reference(packed_scores, ext_bits, *, pack_z: int):
    """Plain K4d front (JAX's _compose_prep, then dilate_cross of the ext).

    packed_scores: uint8 (Xp, Yp, Zs >= pack_z), {0, 1, 3} (bit 0 liver or
    tumour, bit 1 tumour); ext_bits: uint8 (X0, Y0, pack_z/8), the external
    mask's z-crop packed along z. Returns bool (Xp, Yp, pack_z) liver or
    tumour, tumour, and the dilated external mask; the xy compute padding
    beyond (X0, Y0) holds no label and no external mask."""
    m = packed_scores[:, :, :pack_z]
    xp, yp = m.shape[:2]
    x0, y0 = ext_bits.shape[:2]
    if (x0, y0) != (xp, yp):
        real = torch.zeros_like(m)
        real[:x0, :y0] = m[:x0, :y0]
        m = real
    tumor = m >= 3
    liver = (m & 1).bool() | tumor
    ext = torch.zeros((xp, yp, pack_z), dtype=torch.bool, device=m.device)
    ext[:x0, :y0] = unpack_bits_z(ext_bits, pack_z)
    return liver, tumor, dilate_cross_reference(ext)


def pack2bits(mask, *, pack_z: int | None = None):
    """uint8 labelmask with values < 4 -> 2-bit wire, 4 z voxels a byte, the
    first in the low bits (lossless; JAX's _pack2bits); ``pack_z`` first
    crops z. Inverse: ``infer.device_pipeline.unpack2bits``."""
    if pack_z is not None:
        mask = mask[:, :, :pack_z]
    x, y, z = mask.shape
    assert z % 4 == 0, z
    m = mask.reshape(x, y, z // 4, 4)
    return m[..., 0] + 4 * m[..., 1] + 16 * m[..., 2] + 64 * m[..., 3]


def _bbox(labels):
    """Inclusive nonzero bbox (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi) int32;
    an empty axis gives lo = its length, hi = -1 (JAX's _bbox_finish)."""
    nz = labels != 0
    out = []
    for dim in range(3):
        v = nz.any(dim=[d for d in range(3) if d != dim])
        n = v.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=labels.device)
        out += [int(torch.where(v, idx, n).min()), int(torch.where(v, idx, -1).max())]
    return torch.tensor(out, dtype=torch.int32, device=labels.device)


def compose_finish_reference(liver, tumor):
    """Plain K4d end: (uint8 labelmap {0 bg, 1 liver, 2 tumour}, its 2-bit
    wire, its bbox int32[6]) from the hole-filled liver and tumour."""
    labels = torch.where(tumor, 2, liver.to(torch.uint8)).to(torch.uint8)
    return labels, pack2bits(labels), _bbox(labels)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_mask(name, mask, dtypes=(torch.bool,)):
    if not mask.is_cuda:
        raise ValueError(f"{name}: unsupported device {mask.device}")
    if mask.dtype not in dtypes or mask.dim() != 3 or not mask.is_contiguous():
        raise ValueError(
            f"{name}: kernel takes a contiguous 3-D {dtypes} tensor, got "
            f"{mask.dtype} {tuple(mask.shape)} strides {mask.stride()}"
        )
    if 0 in mask.shape:
        raise ValueError(f"{name}: empty volume {tuple(mask.shape)}")
    _check_size(mask)


def _bricks(shape) -> int:
    """Bricks of the kernels' grid over a volume, those cut short included."""
    bricks = 1
    for size, edge in zip(shape, BRICK):
        bricks *= -(-size // edge)
    return bricks


def _roots_capacity(shape, conn: int) -> int:
    """Most local roots the brick pass can list for a volume: per brick, one
    voxel of every 2x2x2 cell (26-connected pieces cannot share one) or half
    the voxels (6-connected: a checkerboard)."""
    per_brick = (BRICK[0] // 2) * (BRICK[1] // 2) * (BRICK[2] // 2)
    return _bricks(shape) * (per_brick if conn == 26 else BRICK[0] * BRICK[1] * BRICK[2] // 2)


def _filled(mask):
    """One byte of work a brick: whether it holds any of the labelled set."""
    return torch.empty((_bricks(mask.shape),), dtype=torch.uint8, device=mask.device)


def cc_label(mask, conn: int = 26):
    """int32 (X, Y, Z): the smallest flat index of each voxel's component
    (conn 26 or 6), SENT outside the mask. A CPU tensor takes
    :func:`cc_label_reference`; a bool CUDA tensor launches K4a (three
    kernels: brick, merge, finish) and counts the call in
    ``cc_label.launches``, or raises."""
    if conn not in (26, 6):
        raise ValueError(f"cc_label: conn must be 26 or 6, got {conn}")
    if mask.is_cpu:
        return cc_label_reference(mask, conn)
    _check_mask("cc_label", mask)
    label = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    filled = _filled(mask)
    build.run(_lib().hdu_cc_label, "cc_label", mask,
              mask.data_ptr(), label.data_ptr(), filled.data_ptr(), *mask.shape, conn, 0)
    cc_label.launches += 1
    return label


cc_label.launches = 0


def largest_component(mask):
    """Bool mask of the largest 26-connected component (scipy's tie rule).
    A CPU tensor takes :func:`largest_component_reference`; a bool CUDA
    tensor launches K4b (K4a's brick and merge kernels with each piece's
    count, a pass over the local roots, and a finish) and counts the call
    in ``largest_component.launches`` and ``cc_label.launches``, or
    raises."""
    if mask.is_cpu:
        return largest_component_reference(mask)
    _check_mask("largest_component", mask)
    label = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    sizes = torch.empty_like(label)
    roots = torch.empty((_roots_capacity(mask.shape, 26),), dtype=torch.int32, device=mask.device)
    filled = _filled(mask)
    best = torch.empty((1,), dtype=torch.int64, device=mask.device)
    out = torch.empty_like(mask)
    build.run(_lib().hdu_cc_largest, "largest_component", mask,
              mask.data_ptr(), label.data_ptr(), sizes.data_ptr(), roots.data_ptr(),
              filled.data_ptr(), best.data_ptr(), out.data_ptr(), *mask.shape, scratch=True)
    largest_component.launches += 1
    cc_label.launches += 1  # its brick and merge kernels are K4a's
    return out


largest_component.launches = 0


def fill_holes(mask):
    """``ndimage.binary_fill_holes`` (6-connected background). A CPU tensor
    takes :func:`fill_holes_reference`; a bool CUDA tensor launches K4c
    (K4a's brick and merge kernels over the background with each piece's
    border flag, a pass over the local roots, and a finish) and counts the
    call in ``fill_holes.launches`` and ``cc_label.launches``, or raises."""
    if mask.is_cpu:
        return fill_holes_reference(mask)
    _check_mask("fill_holes", mask)
    label = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    flags = torch.empty(mask.shape, dtype=torch.uint8, device=mask.device)
    roots = torch.empty((_roots_capacity(mask.shape, 6),), dtype=torch.int32, device=mask.device)
    filled = _filled(mask)
    out = torch.empty_like(mask)
    build.run(_lib().hdu_cc_fill, "fill_holes", mask,
              mask.data_ptr(), label.data_ptr(), flags.data_ptr(), roots.data_ptr(),
              filled.data_ptr(), out.data_ptr(), *mask.shape, scratch=True)
    fill_holes.launches += 1
    cc_label.launches += 1  # its brick and merge kernels are K4a's
    return out


fill_holes.launches = 0


def compose_prep(packed_scores, ext_bits, *, pack_z: int):
    """(liver or tumour, tumour, dilated external mask), bool (Xp, Yp,
    pack_z); arguments as in :func:`compose_prep_reference`, pack_z a
    multiple of 8. A CPU tensor takes the plain version; CUDA tensors launch
    K4d's prep (one kernel) and count the call in ``compose_prep.launches``,
    or raise."""
    if packed_scores.is_cpu:
        return compose_prep_reference(packed_scores, ext_bits, pack_z=pack_z)
    _check_mask("compose_prep", packed_scores, (torch.uint8,))
    _check_mask("compose_prep", ext_bits, (torch.uint8,))
    xp, yp, zs = packed_scores.shape
    x0, y0, q = ext_bits.shape
    if ext_bits.device != packed_scores.device:
        raise ValueError("compose_prep: scores and ext bits lie on different devices")
    if pack_z % 8 or q * 8 != pack_z or pack_z > zs or x0 > xp or y0 > yp:
        raise ValueError(
            f"compose_prep: scores {tuple(packed_scores.shape)}, ext bits "
            f"{tuple(ext_bits.shape)} and pack_z {pack_z} do not fit"
        )
    liver, tumor, ext = (
        torch.empty((xp, yp, pack_z), dtype=torch.bool, device=packed_scores.device)
        for _ in range(3)
    )
    build.run(_lib().hdu_compose_prep, "compose_prep", packed_scores,
              packed_scores.data_ptr(), ext_bits.data_ptr(), liver.data_ptr(), tumor.data_ptr(),
              ext.data_ptr(), xp, yp, zs, x0, y0, pack_z)
    compose_prep.launches += 1
    return liver, tumor, ext


compose_prep.launches = 0


def compose_finish(liver, tumor):
    """(uint8 labelmap {0,1,2}, its 2-bit wire (X, Y, Z/4), its nonzero bbox
    int32[6]) from the hole-filled liver and the final tumour, bool (X, Y,
    Z) with Z a multiple of 4. A CPU tensor takes the plain version; CUDA
    tensors launch K4d's finish (one kernel) and count the call in
    ``compose_finish.launches``, or raise."""
    if liver.is_cpu:
        return compose_finish_reference(liver, tumor)
    _check_mask("compose_finish", liver)
    _check_mask("compose_finish", tumor)
    if tumor.shape != liver.shape or tumor.device != liver.device or liver.shape[2] % 4:
        raise ValueError(f"compose_finish: liver {tuple(liver.shape)}, tumor {tuple(tumor.shape)}")
    x, y, z = liver.shape
    labels = torch.empty((x, y, z), dtype=torch.uint8, device=liver.device)
    wire = torch.empty((x, y, z // 4), dtype=torch.uint8, device=liver.device)
    bbox = torch.empty((6,), dtype=torch.int32, device=liver.device)
    build.run(_lib().hdu_compose_finish, "compose_finish", liver,
              liver.data_ptr(), tumor.data_ptr(), labels.data_ptr(), wire.data_ptr(),
              bbox.data_ptr(), x, y, z, scratch=True)
    compose_finish.launches += 1
    return labels, wire, bbox


compose_finish.launches = 0
