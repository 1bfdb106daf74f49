"""K4's plain versions on the brick-boundary cases (``ops/cc_cases.py``)
against the JAX package's ``infer/device_postprocess.py`` and scipy.

The kernels of ``csrc/cc.cu`` label one ``cc.BRICK`` at a time and merge
across brick faces, so these masks put components, walls, seals and ties on
brick faces, edges and corners, and take shapes one voxel off a brick
multiple. The kernels run only on a card (``chip_smoke.py`` holds them to
these plain versions on the same cases); here the plain versions are held
byte for byte to JAX and scipy: the int32 labels (26 and 6), the largest
component and the hole fill.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from hdenseunet_tpu.infer import device_postprocess as jdpp
from hdenseunet_tpu.infer import postprocess as jpost
from hdenseunet_tpu_torch.ops import cc, cc_cases

CC_CU = Path(cc.__file__).resolve().parent.parent / "csrc" / "cc.cu"
SHAPE = tuple(2 * b for b in cc.BRICK)  # two bricks on every axis: one interior corner


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def check_all(m):
    """cc_label (26, 6), largest_component and fill_holes: plain version ==
    JAX == scipy, byte for byte."""
    t, j = torch.from_numpy(np.ascontiguousarray(m)), jnp.asarray(m)
    want6 = jdpp._propagate_min(jdpp._cc_seed(j), j, jdpp._neighbor_min_cross, table_copies=1)
    for conn, want in ((26, jdpp.connected_min_labels(j)), (6, want6)):
        got = cc.cc_label_reference(t, conn).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"cc_label {conn} vs JAX")
        np.testing.assert_array_equal(got, cc_cases.scipy_min_labels(m, conn), err_msg=f"cc_label {conn} vs scipy")
    got = cc.largest_component_reference(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdpp.largest_component(j)))
    np.testing.assert_array_equal(got, jpost.largest_component(m))
    got = cc.fill_holes_reference(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdpp.fill_holes(j)))
    np.testing.assert_array_equal(got, ndimage.binary_fill_holes(m))


def test_brick_equals_the_kernel_source():
    src = CC_CU.read_text()
    found = re.search(r"constexpr int kBrickX = (\d+), kBrickY = (\d+), kBrickZ = (\d+);", src)
    assert found, "csrc/cc.cu no longer declares the brick"
    assert tuple(int(v) for v in found.groups()) == cc.BRICK


@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("shape", cc_cases.off_by_one_shapes())
def test_shapes_off_a_brick_multiple(shape, p):
    check_all(np.random.default_rng(sum(shape) + int(100 * p)).random(shape) < p)


@pytest.mark.parametrize("name", list(cc_cases.cases(SHAPE)))
def test_brick_boundary_case(name):
    check_all(cc_cases.cases(SHAPE)[name])


def test_cases_do_what_they_say():
    """The cases test what their names claim: sealed cavities fill and open
    ones do not, the corner touch wins only joined, the tie goes to the
    raster-first piece, the snake is one component through every brick."""
    cases = cc_cases.cases(SHAPE)
    for name, m in cases.items():
        filled = ndimage.binary_fill_holes(m)
        if name.startswith("seal"):
            assert (filled.sum() > m.sum()) == name.endswith("sealed"), name
    assert np.array_equal(ndimage.binary_fill_holes(cases["snake cavity"]), cases["snake cavity"])
    for d in range(4):
        assert jpost.largest_component(cases[f"corner touch {d}"]).sum() == 7
    for name, first in (("tie", "z"), ("tie swapped", "x")):
        got = jpost.largest_component(cases[name])
        assert got.sum() == 6 and (len(set(np.nonzero(got)[2])) > 1) == (first == "z"), name
    assert ndimage.label(cases["snake"], ndimage.generate_binary_structure(3, 3))[1] == 1
    bricks = {tuple(v // b for v, b in zip(idx, cc.BRICK)) for idx in np.argwhere(cases["snake"])}
    assert len(bricks) == 8
