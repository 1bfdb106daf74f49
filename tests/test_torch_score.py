"""K3 (hdenseunet_tpu_torch.ops.score): the scorer's window accumulate and
finish against the JAX package.

The plain versions are held to the JAX scoring program's own expressions:
K3a to ``jax.nn.softmax(logits.astype(f32))[:, :, :, 1:-1]`` and the
``lax.dynamic_update_slice`` loop of device_pipeline.py:1180-1190 (written
out here with jnp), K3b to the average of :1195 and ``_pack_labels`` /
``_pack2bits``, byte for byte. A spy test holds the scorer to one K3a call
per window batch with a nonzero weight and one K3b call per labelmask. The
CUDA kernels are held to the plain versions bit for bit on the card; those
tests take the ``cuda`` fixture and skip without a card. JAX is imported
inside the fixtures that need it, so the card tests also run where JAX is
absent:

    python -m pytest --noconftest -q tests/test_torch_score.py -k cuda
"""
import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.core.config import InferConfig
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.infer import device_pipeline as TD
from hdenseunet_tpu_torch.models.hybrid import HDenseUNet
from hdenseunet_tpu_torch.ops import score as K3

# float32 sums of weighted probabilities, the weights that cover a voxel
# summing to 4 at most (so every sum is below 4, its ulp 2.4e-7): torch's
# and XLA's softmax and multiply-add round apart by an ulp or two a window
ACC_TOL = 1e-6
COLS = 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jnp():
    pytest.importorskip("jax")
    import jax.numpy

    return jax.numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# batches of (starts, weights) over zp = 64 slices: stride-2 runs with
# weight-0 windows and multiplicities 1-3, the second reaching the buffer's
# last slice; the per-window grid's non-aligned, overlapping starts with
# weight-0 padding windows, one past the buffer's end (JAX's dynamic_slice
# clamps it and adds 0)
BATCHES = {
    "stride2_runs": [
        ([0, 2, 4, 6, 8, 10, 12, 14], [1, 1, 1, 1, 0, 3, 0, 1]),
        ([42, 44, 46, 48, 50, 52, 54, 56], [1, 2, 1, 0, 2, 1, 0, 1]),
    ],
    "per_window_grid": [
        ([3, 4, 9, 10, 11, 17, 25, 40], [1, 2, 1, 1, 2, 1, 3, 1]),
        ([41, 47, 50, 53, 55, 56, 62, 0], [1, 1, 2, 1, 0, 1, 0, 0]),
    ],
}
SHAPES = [(40, 24, 64), (8, 8, 64)]


def _logits(rng, wb, x, y, dtype):
    """(wb, x, y, COLS, 3) logits as float32 numpy values exact in dtype."""
    logits = rng.normal(0.0, 3.0, (wb, x, y, COLS, 3)).astype(np.float32)
    if dtype == "bfloat16":
        logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    return logits


def _jax_accumulate(jnp, score, count, batches):
    """The JAX program's acc loop (device_pipeline.py:1178-1190) over the
    batches, each (logits, starts, weights)."""
    import jax
    from jax import lax

    sc, cn = jnp.asarray(score), jnp.asarray(count)
    for logits, starts, weights, dtype in batches:
        wb, x, y, cols, c = logits.shape
        inner = cols - 2
        lg = jnp.asarray(logits).astype(getattr(jnp, dtype))
        probs = jax.nn.softmax(lg.astype(jnp.float32), axis=-1)[:, :, :, 1:-1, :]
        for j in range(wb):
            sj = int(starts[j]) + 1
            w = jnp.float32(weights[j])
            blk = lax.dynamic_slice(sc, (0, 0, sj, 0), (x, y, inner, c))
            sc = lax.dynamic_update_slice(sc, blk + w * probs[j], (0, 0, sj, 0))
            cblk = lax.dynamic_slice(cn, (sj,), (inner,))
            cn = lax.dynamic_update_slice(cn, cblk + w, (sj,))
    return np.asarray(sc), np.asarray(cn)


def _port_accumulate(score, count, batches, device="cpu", fn=None):
    fn = fn or K3.window_accumulate
    sc = torch.from_numpy(score.copy()).to(device)
    cn = torch.from_numpy(count.copy()).to(device)
    for logits, starts, weights, dtype in batches:
        lg = torch.from_numpy(logits).to(device).to(getattr(torch, dtype))
        fn(sc, cn, lg, starts, weights, cols=COLS)
    return sc, cn


def _case(name, shape, dtype, seed=0):
    x, y, zp = shape
    rng = np.random.default_rng(seed + x + zp)
    score = np.zeros((x, y, zp, 3), np.float32)
    count = np.zeros((zp,), np.float32)
    batches = [
        (_logits(rng, len(s), x, y, dtype), np.asarray(s, np.int64), np.asarray(w, np.float32), dtype)
        for s, w in BATCHES[name]
    ]
    return score, count, batches


# --------------------------------------------------------------------------
# K3a: window accumulate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_window_accumulate_plain_matches_jax(jnp, name, shape, dtype):
    score, count, batches = _case(name, shape, dtype)
    want_s, want_c = _jax_accumulate(jnp, score, count, batches)
    got_s, got_c = _port_accumulate(score, count, batches)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=ACC_TOL)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert want_s.max() > 2.5 and want_c.max() == 4  # the windows did add


def test_window_accumulate_reads_strided_logits():
    """Logits in the d-major memory order (layout3d='dhwc'), a view: the
    same sums as from the contiguous copy."""
    score, count, batches = _case("stride2_runs", (16, 8, 64), "float32")
    want = _port_accumulate(score, count, batches)
    strided = []
    for logits, s, w, dtype in batches:
        dmajor = np.ascontiguousarray(logits.transpose(0, 3, 1, 2, 4))  # (wb, cols, x, y, C)
        strided.append((dmajor, s, w, dtype))

    def view(sc, cn, lg, starts, weights, *, cols):
        return K3.window_accumulate(sc, cn, lg.permute(0, 2, 3, 1, 4), starts, weights, cols=cols)

    got = _port_accumulate(score, count, strided, fn=view)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_window_accumulate_cpu_takes_plain_path_without_counting():
    score, count, batches = _case("per_window_grid", (8, 8, 64), "float32")
    before = K3.window_accumulate.launches
    got = _port_accumulate(score, count, batches)
    want = _port_accumulate(score, count, batches, fn=K3.window_accumulate_reference)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K3.window_accumulate.launches == before


def test_window_accumulate_refuses_live_windows_outside_the_buffer():
    score = torch.zeros((4, 4, 16, 3))
    count = torch.zeros((16,))
    logits = torch.zeros((2, 4, 4, COLS, 3))
    K3.window_accumulate(score, count, logits, [8, 12], [1, 0], cols=COLS)  # weight 0 past the end
    for starts in ([9, 10], [-1, 0]):
        with pytest.raises(ValueError, match="reach outside"):
            K3.window_accumulate(score, count, logits, starts, [1, 1], cols=COLS)
    with pytest.raises(ValueError, match="do not fit"):
        K3.window_accumulate(score, count, logits, [0, 2], [1, 1], cols=COLS - 1)


# --------------------------------------------------------------------------
# K3b: average, threshold, pack
# --------------------------------------------------------------------------


def _finish_case(shape, seed=3):
    """(score, count) with ties in every z slice, at (0, z % Y, z) an
    average of exactly 0.5 in the liver channel, at (1, ...) one ulp below,
    at (2, ...) exactly float32(0.9) in the tumour channel, at (3, ...) the
    next score below; the tie voxels' other channel is 0."""
    x, y, zp = shape
    rng = np.random.default_rng(seed)
    # counts whose count + 1e-4 some score divides to exactly float32(0.9)
    count = rng.choice(np.float32([1, 2, 4, 5, 7, 8]), zp)
    denom = count + np.float32(1e-4)  # rounded to float32, as both programs round it
    score = (rng.uniform(0.0, 1.0, (x, y, zp, 3)) * denom[:, None]).astype(np.float32)
    up, down = np.float32(np.inf), np.float32(0)
    for z in range(zp):
        d, t = denom[z], np.float32(0.9)
        half = np.float32(0.5) * d  # exact: a power of two
        cand = np.float32(t * d)
        while np.float32(cand / d) < t:
            cand = np.nextafter(cand, up)
        while np.float32(cand / d) > t:
            cand = np.nextafter(cand, down)
        assert np.float32(cand / d) == t, (z, d)
        lower = cand
        while np.float32(lower / d) == t:
            lower = np.nextafter(lower, down)
        r = z % y
        score[0, r, z, 1:] = half, 0
        score[1, r, z, 1:] = np.nextafter(half, down), 0
        score[2, r, z, 1:] = 0, cand
        score[3, r, z, 1:] = 0, lower
    return score, count


@pytest.mark.parametrize("pack_z", [None, 48, 4])
@pytest.mark.parametrize("shape", [(8, 6, 64), (40, 24, 64)])
def test_score_finish_plain_matches_jax(jnp, shape, pack_z):
    from hdenseunet_tpu.infer import device_pipeline as JD

    score, count = _finish_case(shape)
    probs = jnp.asarray(score) / (jnp.asarray(count)[None, None, :, None] + 1e-4)  # :1195
    want = np.asarray(JD._pack_labels(probs, 0.5, 0.9))
    sc, cn = torch.from_numpy(score), torch.from_numpy(count)
    labels = K3.score_finish(sc, cn, 0.5, 0.9, out="labels", pack_z=pack_z)
    np.testing.assert_array_equal(labels.numpy(), want[:, :, :pack_z])
    wire = K3.score_finish(sc, cn, 0.5, 0.9, out="wire", pack_z=pack_z)
    np.testing.assert_array_equal(wire.numpy(), np.asarray(JD._pack2bits(jnp.asarray(want), pack_z=pack_z)))


def test_score_finish_ties_fall_on_the_threshold():
    """The tie voxels: an average of exactly 0.5 is liver, one ulp below is
    not; exactly float32(0.9) is tumour, one ulp below is not."""
    shape = (8, 6, 16)
    score, count = _finish_case(shape)
    labels = K3.score_finish(torch.from_numpy(score), torch.from_numpy(count), 0.5, 0.9, out="labels").numpy()
    z = np.arange(shape[2])
    assert [labels[i, z % 6, z].tolist() for i in range(4)] == [[1] * 16, [0] * 16, [3] * 16, [0] * 16]


def test_score_finish_refuses_bad_arguments():
    score, count = torch.zeros((4, 4, 16, 3)), torch.zeros((16,))
    with pytest.raises(ValueError, match="out must be"):
        K3.score_finish(score, count, 0.5, 0.9, out="probs")
    with pytest.raises(ValueError, match="pack_z"):
        K3.score_finish(score, count, 0.5, 0.9, out="wire", pack_z=6)
    with pytest.raises(ValueError, match="pack_z"):
        K3.score_finish(score, count, 0.5, 0.9, out="labels", pack_z=20)
    with pytest.raises(ValueError, match="count"):
        K3.score_finish(score, count[:8], 0.5, 0.9, out="labels")
    before = K3.score_finish.launches
    K3.score_finish(score, count, 0.5, 0.9, out="wire")
    assert K3.score_finish.launches == before


# --------------------------------------------------------------------------
# the scorer's calls
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    return init_model(HDenseUNet(preset="tiny"), 0)


@pytest.mark.parametrize("knobs", [{}, dict(dedup_2d=False), dict(shared_2d=True), dict(wire_bits=8)])
def test_scorer_calls_k3_once_per_live_batch_and_once_per_labelmask(tiny_model, monkeypatch, knobs):
    import dataclasses

    cfg = dataclasses.replace(InferConfig(), **knobs)
    scorer = TD.DeviceVolumeScorer(tiny_model, cfg, device="cpu")
    calls = {"window_accumulate": [], "score_finish": []}
    for name in calls:
        real = getattr(K3, name)
        monkeypatch.setattr(
            K3, name, lambda *a, _real=real, _name=name, **kw: calls[_name].append(kw) or _real(*a, **kw))
    vol = np.random.default_rng(5).integers(-200, 251, (32, 32, 24)).astype(np.float32) - 48.0
    lo, hi = 6, 17
    plan = scorer.plan(vol.shape, lo, hi)
    live = int(plan["weights"].any(axis=1).sum())
    assert live > 0
    mask = scorer.labelmask(vol, lo, hi)
    assert len(calls["window_accumulate"]) == live
    assert len(calls["score_finish"]) == 1
    assert calls["score_finish"][0] == dict(out="wire" if not knobs.get("wire_bits") else "labels",
                                            pack_z=plan["zw"])
    probs = scorer.score(vol, lo, hi)
    assert len(calls["window_accumulate"]) == 2 * live and len(calls["score_finish"]) == 1
    # the labelmask is the thresholded average of the probabilities
    want = K3.pack_labels(probs, cfg.thres_liver, cfg.thres_tumor).numpy()
    np.testing.assert_array_equal(mask, want)


# --------------------------------------------------------------------------
# the kernels on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["hwdc", "dhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_cuda_window_accumulate_matches_plain(cuda, name, dtype, layout):
    score, count, batches = _case(name, (40, 24, 64), dtype)
    want = _port_accumulate(score, count, batches, device=cuda, fn=K3.window_accumulate_reference)

    def kernel(sc, cn, lg, starts, weights, *, cols):
        if layout == "dhwc":  # the same values in the d-major memory order
            lg = lg.permute(0, 3, 1, 2, 4).contiguous().permute(0, 2, 3, 1, 4)
        return K3.window_accumulate(sc, cn, lg, starts, weights, cols=cols)

    before = K3.window_accumulate.launches
    got = _port_accumulate(score, count, batches, device=cuda, fn=kernel)
    torch.cuda.synchronize()
    assert K3.window_accumulate.launches == before + len(batches)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("pack_z", [None, 48])
@pytest.mark.parametrize("out", ["labels", "wire"])
def test_cuda_score_finish_matches_plain(cuda, out, pack_z):
    score, count = _finish_case((40, 24, 64))
    sc, cn = torch.from_numpy(score).to(cuda), torch.from_numpy(count).to(cuda)
    want = K3.score_finish_reference(sc, cn, 0.5, 0.9, out=out, pack_z=pack_z)
    before = K3.score_finish.launches
    got = K3.score_finish(sc, cn, 0.5, 0.9, out=out, pack_z=pack_z)
    torch.cuda.synchronize()
    assert K3.score_finish.launches == before + 1
    assert torch.equal(got, want)


def test_cuda_plain_ops_round_as_the_kernel(cuda, capsys):
    """The two roundings K3a repeats (csrc/score.cu): torch's softmax of a
    3-wide float32 row sums its exponentials as (e0 + e2) + e1, and
    ``add_(p, alpha=w)`` rounds once, as a fused multiply-add. Prints the
    share of rows each other order or rounding would get right."""
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = 3 * torch.randn((1 << 22, 3), device=cuda, generator=g)
    want = torch.softmax(logits, dim=-1)
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    e0, e1, e2 = e.unbind(-1)
    orders = {"(e0+e2)+e1": (e0 + e2) + e1, "(e0+e1)+e2": (e0 + e1) + e2, "e0+(e1+e2)": e0 + (e1 + e2)}
    share = {name: float((e / total[:, None] == want).float().mean()) for name, total in orders.items()}
    score = 4 * torch.rand((1 << 22,), device=cuda, generator=g)
    p = torch.rand((1 << 22,), device=cuda, generator=g)
    got = score.clone().add_(p, alpha=3.0)
    fused = (score.double() + 3.0 * p.double()).float()  # 3p is exact in float64
    rounded_twice = score + 3.0 * p
    share["add_ alpha=3 as one rounding"] = float((got == fused).float().mean())
    share["add_ alpha=3 as two roundings"] = float((got == rounded_twice).float().mean())
    with capsys.disabled():
        print(f"\nshares of {logits.shape[0]} rows: {share}")
    assert share["(e0+e2)+e1"] == 1.0 and share["add_ alpha=3 as one rounding"] == 1.0
