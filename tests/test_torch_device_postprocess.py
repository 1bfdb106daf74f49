"""The port's device postprocess (K4's plain versions on the CPU) against the
JAX package's ``infer/device_postprocess.py`` and against scipy.

Every output is integer or boolean, so everything is held byte for byte:
the masks, the int32 labels the connected-component pass converges to, the
2-bit wire and the bbox. Inputs are seeded numpy masks; the densities
include one near the 26-connected percolation point (~0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from hdenseunet_tpu.infer import device_postprocess as jdpp
from hdenseunet_tpu.infer import postprocess as jpost
from hdenseunet_tpu.infer.device_pipeline import DeviceVolumeScorer as JScorer, _pack2bits, _unpack2bits
from hdenseunet_tpu_torch.infer import device_postprocess as dpp
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer, unpack2bits
from hdenseunet_tpu_torch.ops import cc, cc_cases

SHAPES = [(16, 16, 12), (24, 20, 16)]
DENSITIES = [0.08, 0.1, 0.35, 0.55, 0.85]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rand_mask(seed, shape, p):
    return np.random.default_rng(seed).random(shape) < p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seed(*key):
    return sum(ord(c) for c in repr(key)) * 7919 % 2**31


# --------------------------------------------------------------------------
# primitives against JAX and scipy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", DENSITIES)
def test_cc_label_equals_jax_min_labels(shape, p):
    """The int32 labels themselves, not only the masks: every voxel carries
    the smallest flat index of its component, SENT outside."""
    m = _rand_mask(_seed("cc", shape, p), shape, p)
    got = cc.cc_label(_t(m), 26)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdpp.connected_min_labels(jnp.asarray(m))))
    # 6-connected: JAX's propagation with the cross neighbourhood
    seed = jdpp._cc_seed(jnp.asarray(m))
    want6 = jdpp._propagate_min(seed, jnp.asarray(m), jdpp._neighbor_min_cross, table_copies=1)
    np.testing.assert_array_equal(cc.cc_label(_t(m), 6).numpy(), np.asarray(want6))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", DENSITIES)
def test_largest_component_matches_jax_and_scipy(shape, p):
    m = _rand_mask(_seed("largest", shape, p), shape, p)
    got = dpp.largest_component(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdpp.largest_component(jnp.asarray(m))))
    np.testing.assert_array_equal(got, jpost.largest_component(m))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", DENSITIES)
def test_fill_holes_matches_jax_and_scipy(shape, p):
    m = _rand_mask(_seed("fill", shape, p), shape, p)
    got = dpp.fill_holes(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdpp.fill_holes(jnp.asarray(m))))
    np.testing.assert_array_equal(got, ndimage.binary_fill_holes(m))
    # the +N intermediate equals JAX's converged ids
    bg, seed = jdpp._fill_seed(jnp.asarray(m))
    want = jdpp._propagate_min(seed, bg, jdpp._neighbor_min_cross, table_copies=2)
    got_bg, ids = cc.fill_labels_reference(_t(m))
    np.testing.assert_array_equal(got_bg.numpy(), np.asarray(bg))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", DENSITIES)
def test_dilate_cross_matches_jax_and_scipy(p):
    m = _rand_mask(_seed("dil", p), (14, 13, 11), p)
    got = dpp.dilate_cross(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdpp.dilate_cross(jnp.asarray(m))))
    np.testing.assert_array_equal(got, ndimage.binary_dilation(m, iterations=1))


def _both(fn_port, fn_jax, m):
    got = fn_port(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fn_jax(jnp.asarray(m))))
    return got


def test_largest_component_merges_diagonal_touch():
    m = np.zeros((8, 8, 8), bool)
    m[0:2, 0:2, 0:2] = True
    m[2:4, 2:4, 2:4] = True  # touches the first block only at a corner
    m[6:7, 0:1, 0:1] = True
    got = _both(dpp.largest_component, jdpp.largest_component, m)
    np.testing.assert_array_equal(got, jpost.largest_component(m))
    assert got[0, 0, 0] and got[3, 3, 3]


def test_largest_component_tie_picks_raster_first():
    m = np.zeros((10, 10, 6), bool)
    m[0, 0, 0:2] = True
    m[7, 7, 2:4] = True
    got = _both(dpp.largest_component, jdpp.largest_component, m)
    assert got[0, 0, 0] and not got[7, 7, 2]


@pytest.mark.parametrize("value", [False, True])
def test_empty_and_full_masks(value):
    m = np.full((5, 6, 7), value)
    np.testing.assert_array_equal(_both(dpp.largest_component, jdpp.largest_component, m), m)
    np.testing.assert_array_equal(_both(dpp.fill_holes, jdpp.fill_holes, m), m)
    want = np.where(m, np.arange(m.size).reshape(m.shape), cc.SENT)
    if value:
        want[:] = 0
    np.testing.assert_array_equal(cc.cc_label(_t(m)).numpy(), want)


def test_fill_holes_connectivity_is_cross():
    m = np.zeros((9, 9, 9), bool)
    m[2:7, 2:7, 2:7] = True
    m[3:6, 3:6, 3:6] = False  # cavity
    m[2, 2, 2] = False  # a corner breach: the cavity meets the outside only diagonally
    got = _both(dpp.fill_holes, jdpp.fill_holes, m)
    np.testing.assert_array_equal(got, ndimage.binary_fill_holes(m))
    assert got[4, 4, 4]
    m[2, 4, 4] = False  # a face hole: the cavity escapes
    got = _both(dpp.fill_holes, jdpp.fill_holes, m)
    np.testing.assert_array_equal(got, ndimage.binary_fill_holes(m))
    assert not got[3, 4, 4]


def test_neighbours_do_not_wrap():
    """Voxels adjacent in flat order across a row or plane end are not
    neighbours: (x, y, Z-1) and (x, y+1, 0), (x, Y-1, z) and (x+1, 0, z)."""
    m = np.zeros((4, 5, 6), bool)
    m[1, 2, 5] = m[1, 3, 0] = True  # flat neighbours across a z-row end
    m[2, 4, 3] = m[3, 0, 3] = True  # across a y-plane end
    labels = cc.cc_label(_t(m)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jdpp.connected_min_labels(jnp.asarray(m))))
    assert len(np.unique(labels[m])) == 4
    _, n = ndimage.label(m, ndimage.generate_binary_structure(3, 3))
    assert n == 4


def test_components_touching_every_face():
    """Six slabs, one on each face of the box, each its own component,
    and hollow interiors the border reaches or not."""
    shape = (9, 10, 11)
    m = np.zeros(shape, bool)
    m[0, 2:8, 2:9] = m[-1, 2:8, 2:9] = True
    m[2:7, 0, 2:9] = m[2:7, -1, 2:9] = True
    m[2:7, 3:7, 0] = m[2:7, 3:7, -1] = True
    m[3:6, 3:7, 3:8] = True
    m[4, 4:6, 4:7] = False  # an enclosed cavity
    labels = cc.cc_label(_t(m)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jdpp.connected_min_labels(jnp.asarray(m))))
    assert len(np.unique(labels[m])) == 7
    np.testing.assert_array_equal(
        _both(dpp.fill_holes, jdpp.fill_holes, m), ndimage.binary_fill_holes(m)
    )
    np.testing.assert_array_equal(
        _both(dpp.largest_component, jdpp.largest_component, m), jpost.largest_component(m)
    )


def test_fill_holes_refuses_labels_past_int32():
    big = torch.empty((1100, 1100, 1000), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="int32"):
        cc.fill_labels_reference(big)


def test_cpu_tensors_take_the_plain_path_without_counting():
    fns = (cc.cc_label, cc.largest_component, cc.fill_holes, cc.compose_prep, cc.compose_finish)
    before = [fn.launches for fn in fns]
    m = _t(_rand_mask(1, (8, 8, 8), 0.4))
    cc.cc_label(m), cc.largest_component(m), cc.fill_holes(m)
    liver, tumor, _ = cc.compose_prep(m.to(torch.uint8), _t(np.packbits(m.numpy(), axis=2)), pack_z=8)
    cc.compose_finish(liver, tumor)
    assert [fn.launches for fn in fns] == before


# --------------------------------------------------------------------------
# the compose: labelmaps, the 2-bit wire and the bbox
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_labels_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    shape = (18, 16, 12)
    liver = rng.random(shape) < 0.3
    tumor = rng.random(shape) < 0.1
    ext = np.zeros(shape, bool)
    ext[3:14, 3:13, 2:10] = rng.random((11, 10, 8)) < 0.7
    got = dpp.compose_labels(_t(liver), _t(tumor), _t(ext)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jdpp.compose_labels(liver, tumor, ext)))
    np.testing.assert_array_equal(got, jpost.compose_from_masks(liver, tumor, ext))


def test_compose_labels_structured():
    shape = (24, 24, 16)
    liver = np.zeros(shape, bool)
    liver[4:20, 4:20, 3:13] = True
    liver[16, 16, 10] = False  # an internal hole, filled in the final map
    liver[1, 1, 1] = True  # a rival speck
    tumor = np.zeros(shape, bool)
    tumor[8:12, 8:12, 5:9] = True
    ext = np.zeros(shape, bool)
    ext[3:21, 3:21, 2:14] = True
    got = dpp.compose_labels(_t(liver), _t(tumor), _t(ext)).numpy()
    np.testing.assert_array_equal(got, jpost.compose_from_masks(liver, tumor, ext))
    assert got[16, 16, 10] == 1 and got[9, 9, 6] == 2 and got[1, 1, 1] == 0


def _packed_case(seed, x0, y0, z, xp, yp, zp, junk_padding):
    """Packed scores {0,1,3} on the (xp, yp, zp) buffer, the ext mask's
    packed bits on (x0, y0, z), and the host labelmap they should give."""
    rng = np.random.default_rng(seed)
    liver = rng.random((x0, y0, z)) < 0.3
    tumor = rng.random((x0, y0, z)) < 0.08
    packed = np.zeros((xp, yp, zp), np.uint8)
    packed[:x0, :y0, :z] = (liver | tumor).astype(np.uint8) + 2 * tumor.astype(np.uint8)
    if junk_padding:  # real model output in the xy compute padding
        packed[x0:, :, :z] = 1
        packed[:, y0:, :z] = 3
    ext = np.zeros((x0, y0, z), bool)
    ext[2 : x0 - 2, 2 : y0 - 2, 2 : z - 3] = rng.random((x0 - 4, y0 - 4, z - 5)) < 0.8
    ext_bits = np.packbits(ext.astype(np.uint8), axis=2)
    return packed, ext_bits, jpost.compose_from_masks(liver, tumor, ext)


@pytest.mark.parametrize(
    "x0,y0,xp,yp,zp,junk",
    [(16, 16, 16, 16, 24, False), (12, 10, 16, 16, 16, True), (30, 21, 32, 32, 24, True)],
)
def test_compose_packed_and_final_equal_jax(x0, y0, xp, yp, zp, junk):
    z = 16
    packed, ext_bits, host = _packed_case(x0 + y0, x0, y0, z, xp, yp, zp, junk)
    wire = dpp.compose_packed(_t(packed), _t(ext_bits), pack_z=z)
    want_wire = np.asarray(jdpp.compose_packed(jnp.asarray(packed), jnp.asarray(ext_bits), pack_z=z))
    assert wire.dtype == torch.uint8
    np.testing.assert_array_equal(wire.numpy(), want_wire)
    np.testing.assert_array_equal(unpack2bits(wire.numpy())[:x0, :y0], host)
    labels, bbox = dpp.compose_final(_t(packed), _t(ext_bits), pack_z=z)
    want_labels, want_bbox = jdpp.compose_final(jnp.asarray(packed), jnp.asarray(ext_bits), pack_z=z)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    assert bbox.dtype == torch.int32
    np.testing.assert_array_equal(bbox.numpy(), np.asarray(want_bbox))


def test_compose_prep_and_finish_equal_jax_pieces():
    packed, ext_bits, _ = _packed_case(5, 12, 10, 16, 16, 16, 24, True)
    liver, tumor, ext = cc.compose_prep(_t(packed), _t(ext_bits), pack_z=16)
    jl, jt, je = jdpp._compose_prep(jnp.asarray(packed), jnp.asarray(ext_bits), pack_z=16)
    np.testing.assert_array_equal(liver.numpy(), np.asarray(jl | jt))
    np.testing.assert_array_equal(tumor.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jdpp.dilate_cross(je)))
    labels, wire, bbox = cc.compose_finish(liver, tumor)
    want_labels = np.where(np.asarray(jt), 2, np.asarray(jl | jt)).astype(np.uint8)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_array_equal(_unpack2bits(wire.numpy()), want_labels)
    _, want_bbox = jdpp._bbox_finish(jnp.asarray(want_labels))
    np.testing.assert_array_equal(bbox.numpy(), np.asarray(want_bbox))


@pytest.mark.parametrize("shape", [(16, 16, 16)] + cc_cases.compose_shapes())
def test_compose_finish_edges_equal_jax(shape):
    """compose_finish on the edges of its kernel's grid (ops/cc_cases.py:
    empty and full maps, one voxel at each corner, z lengths 4, 8 and 12
    modulo 16): the labelmap, the 2-bit wire (JAX's _pack2bits) and the
    bbox (JAX's _bbox_finish) byte for byte."""
    for name, (liver, tumor) in cc_cases.compose_cases(shape, seed=sum(shape)).items():
        labels, wire, bbox = cc.compose_finish(_t(liver), _t(tumor))
        want = np.where(tumor, 2, liver).astype(np.uint8)
        np.testing.assert_array_equal(labels.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(wire.numpy(), np.asarray(_pack2bits(jnp.asarray(want))), err_msg=name)
        np.testing.assert_array_equal(bbox.numpy(), np.asarray(jdpp._bbox_finish(jnp.asarray(want))[1]), err_msg=name)
        if name == "empty":
            assert bbox.tolist() == [shape[0], -1, shape[1], -1, shape[2], -1]


def test_empty_compose_gives_an_empty_bbox():
    packed = np.zeros((16, 16, 16), np.uint8)
    ext_bits = np.zeros((16, 16, 2), np.uint8)
    labels, bbox = dpp.compose_final(_t(packed), _t(ext_bits), pack_z=16)
    _, want = jdpp.compose_final(jnp.asarray(packed), jnp.asarray(ext_bits), pack_z=16)
    assert not labels.any()
    np.testing.assert_array_equal(bbox.numpy(), np.asarray(want))
    assert bbox[0] > bbox[1]


def test_compose_on_padded_crop_equals_full_volume():
    full_shape = (20, 20, 32)
    rng = np.random.default_rng(7)
    liver, tumor, ext = (np.zeros(full_shape, bool) for _ in range(3))
    liver[:, :, 8:24] = rng.random((20, 20, 16)) < 0.3
    tumor[:, :, 9:22] = rng.random((20, 20, 13)) < 0.08
    ext[:, :, 9:23] = rng.random((20, 20, 14)) < 0.6
    want = jpost.compose_from_masks(liver, tumor, ext)
    z_lo, zw, pad = 7, 24, 4
    pads = ((0, pad), (0, pad), (0, 0))
    crop = lambda a: _t(np.pad(a[:, :, z_lo : z_lo + zw], pads))
    got = np.zeros(full_shape, np.uint8)
    got[:, :, z_lo : z_lo + zw] = dpp.compose_labels(crop(liver), crop(tumor), crop(ext)).numpy()[:20, :20]
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the sparse wire's collect
# --------------------------------------------------------------------------


def _sparse_both(final, x0, y0, z, z_lo, z_full):
    nz = np.argwhere(final)
    if nz.size:
        lo, hi = nz.min(axis=0), nz.max(axis=0)
        bb = np.array([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]], np.int32)
    else:
        bb = np.array([final.shape[0], -1, final.shape[1], -1, final.shape[2], -1], np.int32)
    meta = dict(x0=x0, y0=y0, z=z, z_lo=z_lo, z_full=z_full)
    got = DeviceVolumeScorer.__new__(DeviceVolumeScorer)._collect_sparse((_t(final), _t(bb)), meta)
    want = JScorer.__new__(JScorer)._collect_sparse((jnp.asarray(final), jnp.asarray(bb)), meta)
    np.testing.assert_array_equal(got, want)
    return got


def test_sparse_wire_collect_geometry():
    final = np.zeros((32, 32, 16), np.uint8)
    out = _sparse_both(final, 30, 28, 16, 4, 40)
    assert out.shape == (30, 28, 40) and not out.any()

    final[27:30, 25:28, 13:16] = 2  # the far corner, beside the xy compute padding
    out = _sparse_both(final, 30, 28, 16, 4, 40)
    want = np.zeros((30, 28, 40), np.uint8)
    want[27:30, 25:28, 17:20] = 2
    np.testing.assert_array_equal(out, want)

    final = np.zeros((32, 32, 16), np.uint8)
    final[0:2, 0:3, 0:2] = 1  # the origin
    out = _sparse_both(final, 30, 28, 16, 0, 16)
    want = np.zeros((30, 28, 16), np.uint8)
    want[0:2, 0:3, 0:2] = 1
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_wire_collect_random_blobs(seed):
    """A blob larger than one bucket, reaching past the scored z range."""
    rng = np.random.default_rng(seed)
    final = np.zeros((96, 64, 48), np.uint8)
    final[5:80, 3:61, 10:40] = rng.integers(0, 3, (75, 58, 30))
    _sparse_both(final, 90, 60, 36, 3, 50)
