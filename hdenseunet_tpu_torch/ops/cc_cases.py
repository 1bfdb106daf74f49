"""Masks laid on the brick grid of K4's kernels (``ops/cc.BRICK``): the cases
where a brick-local labelling with a merge across brick faces can go wrong.

Each case function takes a volume shape of at least two bricks on every axis
(except :func:`off_by_one_shapes`, which gives shapes) and returns a bool
(X, Y, Z) numpy mask; features sit at the brick corner nearest the middle.
``tests/test_torch_cc_bricks.py`` holds the plain versions to the JAX
package and scipy on them; ``chip_smoke.py`` holds the kernels to the plain
versions, ``native/postprocess.cpp`` and :func:`scipy_min_labels`.

:func:`compose_cases` and :func:`compose_shapes` are the edges of K4d's
``compose_finish``, whose kernel strides over the volume in 16-voxel z
chunks with a tail of 4-voxel quads: its bbox at the array's ends, empty
and full maps, and z lengths that are not a multiple of 16.
"""
from __future__ import annotations

import numpy as np

from .cc import BRICK, SENT


def off_by_one_shapes(bricks=(1, 1, 1)) -> list[tuple[int, int, int]]:
    """Shapes one voxel under and one over ``bricks`` x BRICK on each axis."""
    bx, by, bz = (k * b for k, b in zip(bricks, BRICK))
    return [(bx - 1, by + 1, bz - 1), (bx + 1, by - 1, bz + 1),
            (bx + 1, by + 1, bz - 1), (bx - 1, by - 1, bz + 1)]


def corner(shape) -> tuple[int, int, int]:
    """The brick corner nearest the middle: the first voxel of a brick."""
    return tuple(max(1, round(s / 2 / b)) * b for s, b in zip(shape, BRICK))


def walls(shape, high: bool = False):
    """One-voxel walls on every brick's low faces (``high``: its high faces),
    closing cavities of one brick each."""
    x, y, z = np.ogrid[: shape[0], : shape[1], : shape[2]]
    at = (lambda a, b: a % b == b - 1) if high else (lambda a, b: a % b == 0)
    return at(x, BRICK[0]) | at(y, BRICK[1]) | at(z, BRICK[2])


def snake(shape, margin: int = 0):
    """One 6-connected path through every brick: lines along z at every
    other x and y inside ``margin``, joined end to end at alternate z ends."""
    m = np.zeros(shape, bool)
    lo, (hx, hy, hz) = margin, (s - margin for s in shape)
    ys = list(range(lo, hy, 2))
    order = [(x, y) for i, x in enumerate(range(lo, hx, 2)) for y in (ys if i % 2 == 0 else ys[::-1])]
    for k, (x, y) in enumerate(order):
        m[x, y, lo:hz] = True
        if k + 1 < len(order):
            nx, ny = order[k + 1]
            m[min(x, nx): max(x, nx) + 1, min(y, ny): max(y, ny) + 1, hz - 1 if k % 2 == 0 else lo] = True
    return m


def snake_cavity(shape):
    """A solid volume with a snake carved inside it, open to the border at
    its first end only: nothing is a hole, unless the snake is cut."""
    m = ~snake(shape, margin=1)
    m[1, 1, 0] = False
    return m


def seal(shape, where: str = "corner", high: bool = False, sealed: bool = True):
    """A hollow box whose cavity's only way out is one wall voxel on a brick
    corner (``where='corner'``) or edge ('edge'), on the low x side of the
    corner's brick or (``high``) the high x side of the brick before;
    ``sealed=False`` opens it."""
    sx, sy, sz = corner(shape)
    if where == "edge":
        sz += BRICK[2] // 2
    if high:
        sx -= 1
    m = np.zeros(shape, bool)
    x0 = sx - 4 if high else sx
    m[x0: x0 + 5, sy - 2: sy + 3, sz - 2: sz + 3] = True
    m[x0 + 1: x0 + 4, sy - 1: sy + 2, sz - 1: sz + 2] = False
    m[sx, sy, sz] = sealed
    return m


def corner_touch(shape, direction: int):
    """Two pieces that touch only across a brick corner (26-connected), one
    of four diagonal directions, with a rival larger than either alone: a
    missed corner hook changes the largest component."""
    cx, cy, cz = corner(shape)
    ya, za = (cy - 1, cy)[direction & 1], (cz - 1, cz)[direction >> 1]
    yb, zb = 2 * cy - 1 - ya, 2 * cz - 1 - za
    m = np.zeros(shape, bool)
    m[cx - 4: cx, ya, za] = True  # 4 voxels ending at the corner, in the bricks before
    m[cx: cx + 3, yb, zb] = True  # 3 voxels from the corner on
    m[0:6, 2, 2] = True  # the rival: 6
    return m


def tie(shape, swap: bool = False):
    """Two largest pieces of equal size, each across a brick face, whose
    roots lie in different bricks; ``swap`` exchanges which is raster-first."""
    cx, cy, cz = corner(shape)
    ya, yb = (cy + 3, cy - 3) if swap else (cy - 3, cy + 3)
    m = np.zeros(shape, bool)
    m[cx - 3, ya, cz - 3: cz + 3] = True  # across a z face
    m[cx - 3: cx + 3, yb, cz + 3] = True  # across an x face
    m[1:4, 1, 1] = True  # a smaller one
    return m


def cases(shape) -> dict[str, np.ndarray]:
    """Every case's mask at one shape, by name."""
    out = {"walls low": walls(shape), "walls high": walls(shape, high=True),
           "snake": snake(shape), "snake cavity": snake_cavity(shape)}
    for where in ("corner", "edge"):
        for high in (False, True):
            for sealed in (True, False):
                name = f"seal {where} {'high' if high else 'low'} {'sealed' if sealed else 'open'}"
                out[name] = seal(shape, where, high, sealed)
    for d in range(4):
        out[f"corner touch {d}"] = corner_touch(shape, d)
    out["tie"], out["tie swapped"] = tie(shape), tie(shape, swap=True)
    return out


def scipy_min_labels(m, conn: int):
    """Each voxel's component minimum (flat index) from scipy's
    ``ndimage.label``, SENT outside the mask: ``cc_label``'s host oracle."""
    from scipy import ndimage

    labels, n = ndimage.label(m, ndimage.generate_binary_structure(3, 3 if conn == 26 else 1))
    mins = np.full(n + 1, SENT, np.int64)
    np.minimum.at(mins, labels.ravel(), np.arange(m.size))
    return np.where(m, mins[labels], SENT).astype(np.int32)


def compose_shapes() -> list[tuple[int, int, int]]:
    """Volumes whose z length is 4, 8 or 12 modulo 16 (a 16-voxel chunk
    spans rows), and an odd row count, so the voxel count is not a multiple
    of 16 either (the 4-voxel tail)."""
    return [(33, 17, z) for z in (4, 8, 12)] + [(9, 7, z) for z in (116, 120, 124)]


def compose_cases(shape, seed: int = 0) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(liver, tumour) bool (X, Y, Z) pairs for ``compose_finish``: an empty
    map, one voxel at each of the 8 corners (tumour at the corners of odd
    index sum, else liver), a map that fills the volume (liver, with tumour
    over a random half), and sparse random liver and tumour."""
    rng = np.random.default_rng(seed)
    empty = np.zeros(shape, bool)
    out = {"empty": (empty, empty)}
    for corner_at in np.ndindex(2, 2, 2):
        at = tuple(c * (s - 1) for c, s in zip(corner_at, shape))
        one = np.zeros(shape, bool)
        one[at] = True
        out[f"corner {at}"] = (empty, one) if sum(corner_at) % 2 else (one, empty)
    out["full"] = (np.ones(shape, bool), rng.random(shape) < 0.5)
    out["random"] = (rng.random(shape) < 0.02, rng.random(shape) < 0.01)
    return out
