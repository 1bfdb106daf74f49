"""steps_per_dispatch in the port (hdenseunet_tpu_torch.train.trainer's
make_multi_step and the grouped train loop) on the CPU, and what makes a
step repeat itself: dropout masks hashed from a device seed and the pools'
fixed-order backwards (models/layers.py).

On the CPU a group of K steps runs eagerly (the card captures and replays
one step; chip_smoke.py holds the graphed steps to eager ones bit for bit),
so here K = 2 is held to K = 1 bit for bit and to the JAX package's
``trainer.train`` with ``steps_per_dispatch = 2``, and the loop's grouping
is held to tests/test_train.py's cases. Tiny preset, 32x32, float32.
"""
from itertools import islice

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hdenseunet_tpu.core.config import Config as JConfig
from hdenseunet_tpu.core.mesh import make_mesh as jax_mesh
from hdenseunet_tpu.models import denseunet2d as J2, layers as JL
from hdenseunet_tpu.train import trainer as JT
from hdenseunet_tpu.utils import guards as JG
from hdenseunet_tpu_torch.core import mesh as M, params as P
from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.data.sampler import synthetic_batches
from hdenseunet_tpu_torch.models import denseunet3d, layers as L
from hdenseunet_tpu_torch.train import checkpoint as C, trainer as T

SIZE, COLS, BATCH = 32, 8, 2
# The step tolerances of tests/test_torch_train.py, float32 on both sides:
# a step's loss within rtol 1e-5 (float32 sums in another order), and
# gradients and moving statistics within atol 1e-5 + rtol 1e-4. Over a run
# step n's loss reads n - 1 updates that each differ within their step's
# bounds, so it is held within n times the loss's; the parameters and
# moving statistics after the group within atol 1e-5 + rtol 1e-4.
LOSS_RTOL = 1e-5
STAT_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cfg(tmp_path, arch="2d", k=2, **train):
    cfg = Config()
    cfg.model.preset, cfg.model.input_size, cfg.model.input_cols = "tiny", SIZE, COLS
    cfg.train.arch, cfg.train.batch, cfg.train.steps_per_dispatch = arch, BATCH, k
    cfg.train.save_path = str(tmp_path / "exp")
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


def _batches(arch, n, seed=0):
    mode = "2d" if arch == "2d" else "hybrid"
    gen = synthetic_batches(mode=mode, batch=BATCH, input_size=SIZE, input_cols=COLS, seed=seed)
    return [next(gen) for _ in range(n)]


def _losses(cfg, batches, monkeypatch, **kwargs):
    """train() on the CPU, returning the final state and every drained loss."""
    seen = []
    orig = T.NaNGuard.check

    def spy(self, loss, step):
        seen.append(loss)
        return orig(self, loss, step)

    with monkeypatch.context() as mp:
        mp.setattr(T.NaNGuard, "check", spy)
        state = T.train(cfg, iter(batches), device="cpu", log_fn=lambda *a: None, **kwargs)
    return state, seen


def _assert_states_equal(a, b):
    sa, sb = C.snapshot(a), C.snapshot(b)
    assert sa["step"] == sb["step"] and torch.equal(sa["generator"], sb["generator"])
    for field in ("params", "bn_state", "momentum"):
        assert sa[field].keys() == sb[field].keys(), field
        for name, leaves in sa[field].items():
            for leaf, t in leaves.items():
                assert torch.equal(t, sb[field][name][leaf]), (field, name, leaf)


# --------------------------------------------------------------------------
# K = 2 against K = 1, and against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["2d", "end2end"])
def test_two_steps_per_dispatch_equal_single_steps(tmp_path, monkeypatch, arch):
    """Two groups of 2 and a tail step equal 5 single steps bit for bit:
    every loss, parameter, moving statistic, momentum buffer, the step and
    the dropout generator (dropout live)."""
    batches = _batches(arch, 5)
    one, l1 = _losses(_cfg(tmp_path / "a", arch, k=1, log_every_steps=1), batches, monkeypatch, max_steps=5)
    two, l2 = _losses(_cfg(tmp_path / "b", arch, k=2, log_every_steps=1), batches, monkeypatch, max_steps=5)
    assert l1 == l2 and len(l1) == 5 and one.step == two.step == 5
    _assert_states_equal(one, two)


def _jax_weights(arch):
    """The JAX package's seeded init as {layer: {leaf: array}}, params and
    moving statistics merged, for both packages' warm start."""
    params, state = J2.init(jax.random.key(0), input_size=SIZE, **J2.PRESETS["tiny"])
    merged = {n: {l: np.asarray(a) for l, a in d.items()} for n, d in params.items()}
    for n, d in state.items():
        merged.setdefault(n, {}).update({l: np.asarray(a) for l, a in d.items()})
    return merged


def test_two_steps_per_dispatch_match_jax(tmp_path, monkeypatch):
    """The port's train() with steps_per_dispatch 2 against the JAX
    package's (a lax.scan over each group), 2D stage, dropout the identity
    in both, the same weights (a warm start of both from JAX's init) and
    batches, one group: both losses, the parameters and the moving
    statistics within the step tolerances (LOSS_RTOL, STAT_TOL). One group
    only: from the third step on this tiny model's first conv takes
    gradients of order 10-50 at lr 1e-3, and the JAX package's own K = 1
    and K = 2 runs part by 3 % of its kernel's movement."""
    steps, weights, batches = 2, _jax_weights("2d"), _batches("2d", 2, seed=2)
    pcfg = _cfg(tmp_path / "port", log_every_steps=1)
    jcfg = JConfig.from_json(pcfg.to_json())
    jcfg.train.save_path = str(tmp_path / "jax")
    jseen = []
    jorig = JG.NaNGuard.check

    def jspy(self, loss, step):
        jseen.append(loss)
        return jorig(self, loss, step)

    monkeypatch.setattr(L, "dropout", lambda x, rate, seed=None, **kw: x)
    with monkeypatch.context() as mp:
        mp.setattr(JL, "dropout", lambda ctx, x, rate: x)
        mp.setattr(JG.NaNGuard, "check", jspy)
        ts = JT.train(jcfg, iter(batches), mesh=jax_mesh(jax.devices()[:1]), max_steps=steps,
                      init_weights=weights, log_fn=lambda *a: None)
    state, seen = _losses(pcfg, batches, monkeypatch, max_steps=steps, init_weights=weights)
    assert state.step == int(ts.step) == steps and len(seen) == len(jseen) == steps
    for n, (got, want) in enumerate(zip(seen, jseen), 1):  # step n reads n - 1 updates
        assert abs(got - want) <= n * LOSS_RTOL * abs(want), (n, got, want)
    params, bn = P.to_numpy(state.model)
    for got, want in ((params, ts.params), (bn, ts.bn_state)):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[name][leaf], np.asarray(w), **STAT_TOL, err_msg=f"{name}/{leaf}")


# --------------------------------------------------------------------------
# the loop's grouping (tests/test_train.py:300-400)
# --------------------------------------------------------------------------


def test_partial_tail_and_overshoot_clamp(tmp_path):
    """k = 2: a finite feed's trailing partial group still trains, and
    max_steps is never overshot, every step's loss logged."""
    cfg = _cfg(tmp_path, steps_per_epoch=100, log_every_steps=100)
    state = T.train(cfg, islice(synthetic_batches(mode="2d", batch=BATCH, input_size=SIZE, seed=3), 5),
                    max_steps=100, device="cpu", log_fn=lambda *a: None)
    assert state.step == 5
    cfg.train.save_path = str(tmp_path / "exp2")
    state = T.train(cfg, islice(synthetic_batches(mode="2d", batch=BATCH, input_size=SIZE, seed=4), 10),
                    max_steps=3, device="cpu", log_fn=lambda *a: None)
    assert state.step == 3
    assert (tmp_path / "exp2" / "history" / "lossbatch.txt").read_text().count("\n") == 3


def test_epochs_coprime_with_dispatch(tmp_path):
    """steps_per_epoch 3 against k = 2: epoch ends fall inside a group and
    still fire."""
    cfg = _cfg(tmp_path, steps_per_epoch=3, log_every_steps=3)
    logs = []
    state = T.train(cfg, iter(_batches("2d", 6, seed=5)), max_steps=6, device="cpu", log_fn=logs.append)
    assert state.step == 6
    assert any(m.startswith("epoch 1") for m in logs) and any(m.startswith("epoch 2") for m in logs), logs
    assert (tmp_path / "exp" / "history" / "lossepoch.txt").read_text().count("\n") == 2


def test_nan_in_a_group_raises_before_any_save(tmp_path):
    """A NaN inside a group of 2 raises at the group's drain, before the
    checkpoint cadence inside that group can save."""
    cfg = _cfg(tmp_path, steps_per_epoch=100, log_every_steps=50, checkpoint_every_steps=2)

    def poisoned():
        for b in synthetic_batches(mode="2d", batch=BATCH, input_size=SIZE, seed=6):
            b["image"] = np.full_like(b["image"], np.nan)
            yield b

    with pytest.raises(FloatingPointError, match="non-finite loss nan at step 2"):
        T.train(cfg, poisoned(), max_steps=10, checkpoint_dir=str(tmp_path / "ck"),
                device="cpu", log_fn=lambda *a: None)
    assert C.Checkpointer(tmp_path / "ck").all_steps() == []


def test_resume_at_a_group_boundary_continues_bit_for_bit(tmp_path):
    """k = 2: 4 steps in one run equal 2 steps, a save, a resume and 2 more,
    bit for bit, saves included."""
    cfg = _cfg(tmp_path, checkpoint_every_steps=2, log_every_steps=2)
    batches = _batches("2d", 4, seed=7)
    one = T.train(cfg, iter(batches), max_steps=4, checkpoint_dir=str(tmp_path / "a"),
                  device="cpu", log_fn=lambda *a: None)
    T.train(cfg, iter(batches[:2]), max_steps=2, checkpoint_dir=str(tmp_path / "b"),
            device="cpu", log_fn=lambda *a: None)
    logged = []
    two = T.train(cfg, iter(batches[2:]), max_steps=2, checkpoint_dir=str(tmp_path / "b"),
                  resume=True, device="cpu", log_fn=logged.append)
    assert logged[0] == "resumed from step 2" and two.step == 4
    _assert_states_equal(one, two)
    assert C.Checkpointer(tmp_path / "a").all_steps() == [2, 4] == C.Checkpointer(tmp_path / "b").all_steps()


def test_gloo_group_refuses_steps_per_dispatch(tmp_path):
    """Under a gloo process group K > 1 raises (gloo's collectives cannot be
    captured in a CUDA graph); K = 1 trains."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh = M.make_mesh("cpu")
        with pytest.raises(NotImplementedError, match="gloo"):
            T.train(_cfg(tmp_path), iter(_batches("2d", 2)), mesh=mesh, max_steps=2, device="cpu")
        state = T.train(_cfg(tmp_path, k=1), iter(_batches("2d", 1)), mesh=mesh, max_steps=1,
                        device="cpu", log_fn=lambda *a: None)
        assert state.step == 1
    finally:
        dist.destroy_process_group()


def test_momentum_buffers_are_made_with_the_optimizer(tmp_path):
    """Every trained leaf has a zero momentum buffer before any step, and a
    step writes it in place (a captured step holds the buffers)."""
    cfg = _cfg(tmp_path, k=1)
    state = T.create_train_state(cfg, "2d", device="cpu")
    bufs = {t: s["momentum_buffer"] for t, s in state.optimizer.state.items()}
    trained = [t for g in state.optimizer.param_groups for t in g["params"]]
    assert set(bufs) == set(trained) and all(not b.any() for b in bufs.values())
    addresses = {t: b.data_ptr() for t, b in bufs.items()}
    T.train_step(state, _batches("2d", 1)[0], cfg)
    assert {t: s["momentum_buffer"].data_ptr() for t, s in state.optimizer.state.items()} == addresses
    assert any(s["momentum_buffer"].any() for s in state.optimizer.state.values())


# --------------------------------------------------------------------------
# dropout from a device seed
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2**62 - 1])
def test_keep_fraction_within_binomial_bounds(rate, seed):
    """The share of kept elements of a 2x64x40x40 tensor within 5 standard
    deviations of 1 - rate, the kept ones scaled by 1 / (1 - rate)."""
    x = torch.ones((2, 64, 40, 40)).contiguous(memory_format=torch.channels_last)
    ctx = L.Ctx(seed, device="cpu")
    y = L.maybe_dropout(ctx, x, rate)
    kept = y != 0
    keep = 1 - rate
    assert abs(float(kept.float().mean()) - keep) < 5 * (keep * rate / x.numel()) ** 0.5
    assert torch.allclose(y[kept], torch.tensor(1 / keep))
    assert y.stride() == x.stride()


def test_masks_are_a_function_of_the_seed_alone():
    """The same seed as an int or a tensor gives the same mask; seeds that
    share their low 32 bits do not; a block's seed comes from its parent's
    and its index, the same on a recomputation."""
    x = torch.ones((4, 8, 16, 16))
    a = L.maybe_dropout(L.Ctx(5, device="cpu"), x, 0.3)
    assert torch.equal(a, L.maybe_dropout(L.Ctx(torch.tensor(5), device="cpu"), x, 0.3))
    assert not torch.equal(a, L.maybe_dropout(L.Ctx(5 + 2**32, device="cpu"), x, 0.3))
    ctx = L.Ctx(5, device="cpu")
    first, second = ctx.child_seed(), ctx.child_seed()
    assert torch.equal(first(), first()) and not torch.equal(first(), second())
    child = L.Ctx(first, device="cpu")
    assert not torch.equal(L.maybe_dropout(child, x, 0.3), a)
    assert torch.equal(L.maybe_dropout(child, x, 0.3), L.maybe_dropout(L.Ctx(first, device="cpu"), x, 0.3))


def test_masks_do_not_depend_on_remat_3d():
    """The tiny 3D DenseUNet with block dropout live: remat on and off draw
    the same masks, so loss and gradients agree."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 32, 4, 4)).astype(np.float32))
    out = []
    for remat in (False, True):
        model = init_model(denseunet3d.DenseUNet3D(**denseunet3d.PRESETS["tiny"]), 0)
        _, logits = model(x, L.Ctx(9, device="cpu", remat=remat), block_dropout=0.2)
        loss = (logits.float() ** 2).mean()
        loss.backward()
        out.append((loss.item(), {n: t.grad.clone() for n, t in model.named_parameters() if t.grad is not None}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("ranks", [2, 4])
def test_split_batch_mask_is_one_process_rows(ranks):
    """A context whose batch is split over ranks draws its rows of the mask
    one process draws from the same seed over the whole batch."""
    x = torch.randn((2 * ranks, 6, 8, 8, 4)).contiguous(memory_format=torch.channels_last_3d) + 3
    want = L.maybe_dropout(L.Ctx(3, device="cpu"), x, 0.3)
    for r in range(ranks):
        ctx = L.Ctx(3, device="cpu")
        ctx.shard = (r, ranks)
        got = L.maybe_dropout(ctx, x[2 * r:2 * r + 2], 0.3)
        assert torch.equal(got, want[2 * r:2 * r + 2]), r


# --------------------------------------------------------------------------
# the pools' fixed-order backwards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ("max3d", (2, 3, 7, 6, 5), dict(window=3, stride=2, pad=1)),
    ("max3d", (1, 2, 8, 8, 4), dict(window=(2, 2, 1), stride=(2, 2, 1))),
    ("avg3d", (2, 3, 7, 6, 5), dict(window=(2, 2, 1), stride=(2, 2, 1))),
    ("avg2d", (2, 3, 7, 6), dict(window=2, stride=2)),
])
def test_pool_backwards_gradcheck(case):
    """float64 gradcheck of each pool's backward, odd sizes included (the
    cells no window covers get no gradient)."""
    kind, shape, kw = case
    fmt = torch.channels_last_3d if len(shape) == 5 else torch.channels_last
    x = torch.randn(shape, dtype=torch.float64).contiguous(memory_format=fmt).requires_grad_()
    fn = L.max_pool if kind.startswith("max") else (lambda t, window, stride: L.avg_pool(t, window, stride))
    assert torch.autograd.gradcheck(lambda t: fn(t, **kw), (x,))


def _jax_layout(t):
    return np.asarray(t.detach().movedim(1, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_gradients_match_jax(kind, dtype):
    """The 3D stem's max pool (3^3, stride 2, zero padding 1) over a ReLU
    output, ties in every window, and the transitions' (2, 2, 1) average
    pool: the port's gradients against jax.vjp of the JAX layers on the
    same input and output gradient. The outputs are equal bit for bit; the
    tie rule is the same (a window's gradient goes to its first maximum: a
    gradient sent elsewhere would miss by far more than the bound); an
    input cell sums the gradients of up to 8 windows, XLA in another order
    (and in bfloat16 for bfloat16), so each cell within 8 units in the last
    place of the dtype (2^-23 float32, 2^-8 bfloat16) of the largest output
    gradient; the average pool's spread is exact."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(2, 9, 8, 6, 4)), 0).astype(np.float32)  # (B, H, W, D, C)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if kind == "max":
        jfn = lambda v: JL.max_pool(v, 3, 2, pad=1)
        tfn = lambda v: L.max_pool(v, 3, 2, pad=1)
    else:
        jfn = lambda v: JL.avg_pool(v, (2, 2, 1), (2, 2, 1))
        tfn = lambda v: L.avg_pool(v, (2, 2, 1), (2, 2, 1))
    jx = jnp.asarray(x, jdt)
    jy, vjp = jax.vjp(jfn, jx)
    g = rng.normal(size=jy.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).movedim(-1, 1).to(dtype).contiguous(memory_format=torch.channels_last_3d)
    tx.requires_grad_()
    ty = tfn(tx)
    np.testing.assert_array_equal(_jax_layout(ty.float()), np.asarray(jy, np.float32))
    ty.backward(torch.from_numpy(g).movedim(-1, 1).to(dtype))
    got, want = _jax_layout(tx.grad.float()), np.asarray(jgrad, np.float32)
    if kind == "avg":
        np.testing.assert_array_equal(got, want)
    else:
        ulp = 2.0**-23 if dtype == torch.float32 else 2.0**-8
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * ulp * np.abs(g).max())


def test_make_multi_step_takes_stacked_or_listed_groups(tmp_path):
    """A group stacked by stack_batches and the same group as a list of
    batches (written slot by slot into the feed) give the same steps."""
    cfg = _cfg(tmp_path, k=2)
    group = _batches("2d", 2, seed=8)
    out = []
    for form in (T.stack_batches(group), group):
        state = T.create_train_state(cfg, "2d", device="cpu")
        losses = T.make_multi_step(state, cfg, None, 2)(form)
        out.append((losses, C.snapshot(state)))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1]["step"] == 2
    for name, leaves in out[0][1]["params"].items():
        for leaf, t in leaves.items():
            assert torch.equal(t, out[1][1]["params"][name][leaf]), (name, leaf)
