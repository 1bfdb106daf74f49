"""The port's training path (hdenseunet_tpu_torch.train) against the JAX
package on CPU: train-mode BatchNorm, the stage masks, the optimizer, one
2D-stage train step, remat, dropout, the host loop, and serving after
training. The hybrid stages' train steps are in test_torch_train_hybrid.py.

Inputs are numpy draws from fixed seeds; weights come from the JAX ``init``
and reach the port through the parameter bridge. The step parity tests patch
both packages' ``layers.dropout`` to the identity (their random bits cannot
match); dropout itself is tested on its own.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hdenseunet_tpu.core.config import Config as JConfig
from hdenseunet_tpu.core.module import Ctx as JCtx, merge_state
from hdenseunet_tpu.models import denseunet2d as J2, hybrid as JH, layers as JL
from hdenseunet_tpu.train import optimizer as JOpt, trainer as JT
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.data.sampler import synthetic_batches
from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops import fused_affine as K, wce as W
from hdenseunet_tpu_torch.train import optimizer as TOpt, trainer as T

SIZE, COLS, BATCH = 32, 8, 2
_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
# Tolerances of one train step, float32 on both sides (test_torch_train*.py):
# * loss: float32 sums in another order, rtol 1e-5;
# * 2D stage: gradients and moving statistics elementwise atol 1e-5 +
#   rtol 1e-4 (measured worst: 7.5 % of that);
# * hybrid stages: gradients within 5e-2 of each tensor's largest magnitude
#   (atol 1e-5 besides). At 32x32x8 and batch 2 the hybrid's float32
#   gradients hang on summation order: two steps of the port that differ
#   only in the convs' memory format differ by 2.6 % of a 2D Scale's largest
#   gradient (test_torch_train_hybrid.py, which also pins this bound);
# * parameters after the update: the gradients' tolerance times lr*(1+m),
#   the first Nesterov step's factor, plus 1e-6 of the parameter.
LOSS_RTOL = 1e-5
STAT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_MAX_RTOL = {"2d": None, "3dpart": 5e-2, "end2end": 5e-2}


def configs(arch, **model):
    """(JAX Config, the port's Config) for a tiny-preset stage; ``model``
    sets ModelConfig fields (the 3D branch's form: layout3d, stem_s2d)."""
    cfg = JConfig()
    cfg.model.preset, cfg.model.input_size, cfg.model.input_cols = "tiny", SIZE, COLS
    cfg.train.arch, cfg.train.batch = arch, BATCH
    for field, value in model.items():
        setattr(cfg.model, field, value)
    return cfg, Config.from_json(cfg.to_json())


def jax_init(arch, seed=0):
    if arch == "2d":
        return J2.init(jax.random.key(seed), input_size=SIZE, **J2.PRESETS["tiny"])
    return JH.init(jax.random.key(seed), input_size=SIZE, input_cols=COLS, preset="tiny")


def make_batch(arch, seed=0):
    mode = "2d" if arch == "2d" else "hybrid"
    return next(synthetic_batches(mode=mode, batch=BATCH, input_size=SIZE, input_cols=COLS, seed=seed))


def jax_step(arch, params, state, batch, **model):
    """The JAX package's step with dropout as the identity: loss, grads, new
    moving statistics and the parameters after make_optimizer's update."""
    cfg, _ = configs(arch, **model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "dropout", lambda ctx, x, rate: x)
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, b: JT._forward_loss(p, s, b, jax.random.key(1), arch=arch, cfg=cfg),
            has_aux=True,
        ))
        (loss, new_bn), grads = fn(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    tx, labels = JOpt.make_optimizer(params, arch, cfg.train.lr, cfg.train.momentum)
    updates, _ = tx.update(grads, tx.init(params), params)
    return dict(
        loss=float(loss), grads=grads, state=merge_state(state, new_bn),
        params=optax.apply_updates(params, updates), labels=labels,
    )


def port_state(arch, params, state, *, remat=True, **model):
    _, pcfg = configs(arch, **model)
    pcfg.train.remat = remat
    st = T.create_train_state(pcfg, arch, device="cpu")
    P.from_numpy(st.model, params, state)
    return st, pcfg


def port_step(arch, params, state, batch, monkeypatch, *, remat=True, **model):
    monkeypatch.setattr(L, "dropout", lambda x, rate, seed=None: x)
    st, pcfg = port_state(arch, params, state, remat=remat, **model)
    loss = T.train_step(st, batch, pcfg)
    return st, float(loss)


def _torch_layout(leaf, arr):
    arr = np.asarray(arr)
    return arr.transpose(_TO_TORCH[arr.ndim]) if leaf == "kernel" and arr.ndim in _TO_TORCH else arr


def assert_step_matches(arch, want, st, loss, params0):
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    lr_factor = st.optimizer.defaults["lr"] * (1 + st.optimizer.defaults["momentum"])
    grad_rtol = GRAD_MAX_RTOL[arch]
    for name, layer in P.layers(st.model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            p_new = _torch_layout(leaf, want["params"][name][leaf])
            if want["labels"][name][leaf] == "freeze":
                assert t.grad is None and not t.requires_grad, (name, leaf)
                np.testing.assert_array_equal(t.detach().numpy(), _torch_layout(leaf, params0[name][leaf]))
                np.testing.assert_array_equal(p_new, _torch_layout(leaf, params0[name][leaf]))
                continue
            g_want = _torch_layout(leaf, want["grads"][name][leaf])
            # a layer whose output the loss never reads (the 3D branch's own
            # classifier) has no .grad; JAX's is exactly 0
            g_got = np.zeros_like(g_want) if t.grad is None else t.grad.numpy()
            if grad_rtol is None:
                np.testing.assert_allclose(g_got, g_want, **STAT_TOL, err_msg=f"{name}/{leaf}")
                g_tol = STAT_TOL["atol"] + STAT_TOL["rtol"] * np.abs(g_want)
            else:
                g_tol = 1e-5 + grad_rtol * np.abs(g_want).max()
                assert np.abs(g_got - g_want).max() <= g_tol, (name, leaf)
            p_got = t.detach().numpy()
            assert np.all(np.abs(p_got - p_new) <= lr_factor * g_tol + 1e-6 * np.abs(p_new) + 1e-12), (
                name, leaf,
            )
        for leaf, t in layer.named_buffers(recurse=False):
            np.testing.assert_allclose(
                t.numpy(), np.asarray(want["state"][name][leaf]), **STAT_TOL, err_msg=f"{name}/{leaf}"
            )


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inits():
    return {arch: jax_init(arch) for arch in ("2d", "end2end")}


# --------------------------------------------------------------------------
# layers in training mode
# --------------------------------------------------------------------------


def _to_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-3, 1.1e-5])
@pytest.mark.parametrize("shape", [(2, 8, 6, 12), (2, 8, 6, 4, 12)])
def test_train_batch_norm_matches_jax(shape, eps, dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    c = shape[-1]
    p = {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)}
    s = {
        "moving_mean": rng.normal(size=c).astype(np.float32),
        "moving_variance": rng.uniform(0.2, 2.0, c).astype(np.float32),
    }
    jctx = JCtx({"bn": p}, {"bn": s}, train=True)
    want = JL.batch_norm(jctx, jnp.asarray(x, getattr(jnp, dtype)), "bn", eps=eps)
    bn = P.from_numpy(nn.ModuleDict({"bn": L.BatchNorm(c, eps=eps)}), {"bn": p}, {"bn": s})["bn"]
    ctx = L.Ctx(0, device="cpu")
    with torch.no_grad():
        got = bn(_to_torch(x).to(getattr(torch, dtype)), ctx)
    # float32 statistics on both sides; the output is rounded to the dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(
        got.movedim(1, -1).float().numpy(), np.asarray(want.astype(jnp.float32)), **tol
    )
    new_mean, new_var = ctx.new_stats[bn]
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(jctx.new_state["bn"]["moving_mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(jctx.new_state["bn"]["moving_variance"]), rtol=1e-6, atol=1e-6)
    # the buffers themselves move only when the trainer merges the step
    np.testing.assert_array_equal(bn.moving_mean.numpy(), s["moving_mean"])


@pytest.mark.parametrize("frozen", [False, True])
def test_train_bn_scale_relu_matches_jax_with_gradients(frozen):
    """Live statistics: BN, Scale and ReLU as three plain ops; frozen: the
    fold and K1 through AffineReLU. Output and gradients of x and every
    BN/Scale leaf against jax.grad of layers.bn_scale_relu."""
    rng = np.random.default_rng(6)
    c = 36
    x = rng.normal(size=(2, 8, 6, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = {
        "bn": {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)},
        "sc": {"gamma": rng.normal(1, 0.3, c).astype(np.float32), "beta": rng.normal(size=c).astype(np.float32)},
    }
    s = {"bn": {"moving_mean": rng.normal(size=c).astype(np.float32),
                "moving_variance": rng.uniform(0.2, 2.0, c).astype(np.float32)}}

    def jfn(params, xj):
        ctx = JCtx(params, s, train=True)
        y = JL.bn_scale_relu(ctx, xj, "bn", "sc", eps=1.1e-5, frozen=frozen)
        return jnp.sum(y * g), y

    (_, want_y), (want_gp, want_gx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x)
    )
    md = P.from_numpy(nn.ModuleDict({"bn": L.BatchNorm(c, eps=1.1e-5), "sc": L.Scale(c)}), p, s)
    xt = _to_torch(x).requires_grad_()
    y = L.bn_scale_relu(xt, md["bn"], md["sc"], ctx=L.Ctx(0, device="cpu"), frozen=frozen)
    (y * _to_torch(g)).sum().backward()
    np.testing.assert_allclose(y.detach().movedim(1, -1).numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.movedim(1, -1).numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-5)
    for layer in ("bn", "sc"):
        for leaf in ("gamma", "beta"):
            got = getattr(md[layer], leaf).grad.numpy()
            np.testing.assert_allclose(got, np.asarray(want_gp[layer][leaf]), rtol=1e-4, atol=1e-4)


def test_dropout_keep_rate_scaling_and_eval_identity():
    x = torch.full((400, 500), 3.0)
    seed = torch.tensor(0)
    y = L.dropout(x, 0.3, seed)
    kept = y != 0
    # 200k Bernoulli(0.7) draws: the kept share within 5 standard deviations
    assert abs(float(kept.float().mean()) - 0.7) < 5 * (0.7 * 0.3 / x.numel()) ** 0.5
    assert torch.allclose(y[kept], torch.tensor(3.0 / 0.7))
    assert L.dropout(x, 0.3) is x and L.dropout(x, 0.0, seed) is x  # inference / rate 0
    assert L.maybe_dropout(None, x, 0.3) is x
    bf = x.to(torch.bfloat16).movedim(-1, 0)
    assert L.dropout(bf, 0.1, seed).stride() == bf.stride()  # keeps the memory format
    a = L.dropout(x, 0.3, torch.tensor(7))
    assert torch.equal(a, L.dropout(x, 0.3, torch.tensor(7)))
    assert not torch.equal(a, y)  # another seed, another mask


def test_dropout_masks_do_not_depend_on_remat(inits):
    """With block and decoder dropout live, remat on and off draw the same
    masks (each conv block draws from its own child seed), so a recomputed
    block redraws its forward's masks: loss and gradients agree."""
    params, state = inits["2d"]
    x = torch.from_numpy(make_batch("2d", seed=3)["image"])
    out = []
    for remat in (False, True):
        model = P.from_numpy(T.build_model(configs("2d")[1], "2d"), params, state)
        ctx = L.Ctx(5, device="cpu", remat=remat)
        _, logits = model(x, ctx, decoder_dropout=0.3, block_dropout=0.2)
        loss = (logits.float() ** 2).mean()
        loss.backward()
        out.append((loss.item(), {n: t.grad for n, t in model.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=1e-6, atol=1e-8)
    model.zero_grad()
    with torch.no_grad():
        _, nodrop = model(x, L.Ctx(5, device="cpu"), block_dropout=0.0, decoder_dropout=0.0)
    assert not torch.allclose(logits, nodrop)  # the masks did drop something


# --------------------------------------------------------------------------
# stage masks and optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["2d", "3dpart", "end2end"])
def test_trainable_set_matches_jax(inits, arch):
    params, state = inits["2d" if arch == "2d" else "end2end"]
    want = JOpt.trainable_labels(params, arch)
    st, _ = port_state(arch, params, state)
    assert st.labels == want
    assert TOpt.count_trainable(st.model, st.labels) == JOpt.count_trainable(params, want)
    flags = {(n, l): t.requires_grad for n, layer in P.layers(st.model).items()
             for l, t in layer.named_parameters(recurse=False)}
    assert flags == {(n, l): v == "train" for n, d in want.items() for l, v in d.items()}
    trained = {id(t) for group in st.optimizer.param_groups for t in group["params"]}
    assert {k for k, v in flags.items() if v} == {
        (n, l) for n, layer in P.layers(st.model).items()
        for l, t in layer.named_parameters(recurse=False) if id(t) in trained
    }


def test_three_optimizer_steps_match_optax(inits):
    """SGD-Nesterov on the same gradients for three steps, end2end's mask:
    trained leaves move as optax moves them, frozen ones not at all."""
    params, state = inits["end2end"]
    st, _ = port_state("end2end", params, state)
    tx, labels = JOpt.make_optimizer(params, "end2end", 1e-3)
    opt_state = tx.init(params)
    jp = params
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = {n: {l: rng.normal(size=np.shape(a)).astype(np.float32) for l, a in d.items()}
                 for n, d in params.items()}
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, layer in P.layers(st.model).items():
            for leaf, t in layer.named_parameters(recurse=False):
                if t.requires_grad:
                    t.grad = torch.from_numpy(_torch_layout(leaf, grads[name][leaf]).copy())
        st.optimizer.step()
    for name, layer in P.layers(st.model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            np.testing.assert_allclose(
                t.detach().numpy(), _torch_layout(leaf, jp[name][leaf]), rtol=1e-6, atol=1e-6,
                err_msg=f"{name}/{leaf}",
            )


# --------------------------------------------------------------------------
# one train step of the 2D stage against the JAX package's
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_2d_step(inits):
    params, state = inits["2d"]
    return jax_step("2d", params, state, make_batch("2d"))


def test_train_step_2d_matches_jax(inits, jax_2d_step, monkeypatch):
    params, state = inits["2d"]
    st, loss = port_step("2d", params, state, make_batch("2d"), monkeypatch)
    assert_step_matches("2d", jax_2d_step, st, loss, params)


@pytest.mark.parametrize("arch", ["2d", "end2end"])
def test_remat_on_and_off_agree(inits, arch, monkeypatch):
    """Same loss, gradients and moving statistics: a recomputed block
    rewrites its BN statistics instead of applying the update twice."""
    params, state = inits[arch]
    batch = make_batch(arch, seed=4)
    runs = [port_step(arch, params, state, batch, monkeypatch, remat=r) for r in (False, True)]
    (off, loss_off), (on, loss_on) = runs
    assert loss_on == loss_off
    for (name, a), (_, b) in zip(P.layers(off.model).items(), P.layers(on.model).items()):
        for leaf, t in a.named_parameters(recurse=False):
            u = getattr(b, leaf)
            assert (t.grad is None) == (u.grad is None), (name, leaf)
            if t.grad is not None:
                torch.testing.assert_close(u.grad, t.grad, rtol=1e-6, atol=1e-8)
        for leaf, t in a.named_buffers(recurse=False):
            torch.testing.assert_close(getattr(b, leaf), t, rtol=0, atol=0)
    moved = [n for n, l in P.layers(on.model).items() if isinstance(l, L.BatchNorm)
             and not np.array_equal(l.moving_mean.numpy(), np.asarray(state[n]["moving_mean"]))]
    assert moved  # live BNs updated their statistics


def test_eval_step_matches_jax(inits):
    params, state = inits["2d"]
    cfg, pcfg = configs("2d")
    batch = make_batch("2d", seed=8)
    want, _ = JT._forward_loss(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()}, None, arch="2d", cfg=cfg,
        train=False,
    )
    st, _ = port_state("2d", params, state)
    got = T.eval_step(st, batch, pcfg)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


# --------------------------------------------------------------------------
# the host loop, the NaN guard, and serving after training
# --------------------------------------------------------------------------


def _loop_cfg(tmp_path, arch="end2end"):
    _, pcfg = configs(arch)
    pcfg.train.save_path = str(tmp_path)
    pcfg.train.log_every_steps = 2
    pcfg.train.steps_per_epoch = 3
    return pcfg


def test_train_loop_logs_and_writes_history(tmp_path):
    pcfg = _loop_cfg(tmp_path)
    counts = lambda: (K.affine_relu.launches, K.affine_relu_backward.launches,
                      W.wce_forward.launches, W.wce_backward.launches)
    before = counts()
    checked, logged = [], []
    orig = T.NaNGuard.check

    def spy(self, loss, step):
        checked.append(step)
        return orig(self, loss, step)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T.NaNGuard, "check", spy)
        batches = synthetic_batches(mode="hybrid", batch=BATCH, input_size=SIZE, input_cols=COLS, seed=1)
        state = T.train(pcfg, batches, max_steps=5, device="cpu", log_fn=logged.append)
    # drains: the log cadence at 2 and 4, the epoch end at 3, the run's end at 5
    assert state.step == 5 and checked == [2, 2, 3, 4, 5]
    assert len(logged) == 1 and logged[0].startswith("epoch 1: loss=")
    hist = tmp_path / "history"
    batch_losses = (hist / "lossbatch.txt").read_text().split()
    assert len(batch_losses) == 5 and all(np.isfinite(float(v)) for v in batch_losses)
    assert len((hist / "lossepoch.txt").read_text().split()) == 1
    assert counts() == before  # on the CPU every kernel wrapper takes its plain version


def test_nan_batch_raises(tmp_path):
    pcfg = _loop_cfg(tmp_path, arch="2d")
    pcfg.train.log_every_steps = 1

    def batches():
        clean = synthetic_batches(mode="2d", batch=BATCH, input_size=SIZE, seed=2)
        yield next(clean)
        bad = next(clean)
        bad["image"][0, 0, 0, 0] = np.nan
        yield bad
        yield next(clean)

    with pytest.raises(FloatingPointError, match="non-finite loss nan at step 2"):
        T.train(pcfg, batches(), max_steps=3, device="cpu", log_fn=lambda *a: None)


@pytest.mark.parametrize(
    "field,value",
    [("steps_per_dispatch", 2), ("remat_policy", "convs"), ("layout3d", "dhwc"),
     ("checkpoint_dir", "ck"), ("resume", True), ("init_weights", {})],
)
def test_unported_training_options_raise(tmp_path, field, value):
    """No training option raises any more. Checkpoints, resume, the warm
    start, remat_policy='convs', steps_per_dispatch and the d-major 3D
    layout have been ported since, and the loop now takes them
    (test_torch_checkpoint.py, test_torch_cli.py, test_torch_remat.py,
    test_torch_multistep.py and test_torch_forms_train.py test what they
    do)."""
    pcfg = _loop_cfg(tmp_path)
    kwargs = {}
    if field == "steps_per_dispatch":  # a group of 2 and a single step after it
        pcfg.train.steps_per_dispatch = value
        batches = synthetic_batches(mode="hybrid", batch=BATCH, input_size=SIZE, input_cols=COLS, seed=1)
        logged = []
        assert T.train(pcfg, batches, max_steps=3, device="cpu", log_fn=logged.append).step == 3
        assert logged[-1].startswith("steps_per_dispatch 2: 2 steps in groups")
        return
    if field == "remat_policy":
        pcfg.train.remat_policy = value
        assert T.train(pcfg, iter(()), max_steps=1, device="cpu", log_fn=lambda *a: None).step == 0
        return
    if field in ("checkpoint_dir", "resume", "init_weights"):
        kwargs[field] = str(tmp_path / value) if field == "checkpoint_dir" else value
        logged = []
        state = T.train(pcfg, iter(()), max_steps=1, device="cpu", log_fn=logged.append, **kwargs)
        assert state.step == 0
        if field == "checkpoint_dir":
            assert (tmp_path / value / "step-0.pt").is_file()
        if field == "init_weights":  # a warm start from nothing loads nothing
            assert logged == ["warm start: 0 layers loaded, 0 skipped, 0 shape-mismatched"]
        return
    assert field == "layout3d"  # two d-major steps, finite losses
    pcfg.model.layout3d = value
    batches = synthetic_batches(mode="hybrid", batch=BATCH, input_size=SIZE, input_cols=COLS, seed=1)
    assert T.train(pcfg, batches, max_steps=2, device="cpu", log_fn=lambda *a: None).step == 2
    losses = (tmp_path / "history" / "lossbatch.txt").read_text().split()
    assert len(losses) == 2 and all(np.isfinite(float(v)) for v in losses)


def test_scorer_after_training_serves_the_trained_weights(inits):
    """A scorer folds every BN∘Scale pair when it takes the model; a train
    step must neither read that stale fold nor leave it behind."""
    params, state = inits["end2end"]
    _, pcfg = configs("end2end")
    vol = np.random.default_rng(3).normal(0, 50, (32, 32, 20)).astype(np.float32)
    batch = make_batch("end2end", seed=5)
    served, _ = port_state("end2end", params, state)
    first = DeviceVolumeScorer(served.model, pcfg.infer, device="cpu")
    assert all(m.folded is not None for m in served.model.modules() if isinstance(m, L.Scale))
    plain, _ = port_state("end2end", params, state)  # never folded
    steps = []
    for st in (served, plain):
        before = copy.deepcopy(st.model.state_dict())
        st.generator.manual_seed(0)
        T.train_step(st, batch, pcfg)
        steps.append({k: v - before[k] for k, v in st.model.state_dict().items()})
    # the same step, up to the hybrid's float32 conditioning (GRAD_MAX_RTOL:
    # the scorer's channels-last conv weights sum in another order); with the
    # stale fold no update would reach the Scales. (A conv bias in front of a
    # live BN has a zero gradient in exact arithmetic: 1e-9 absolute.)
    # An update is read as the difference of two float32 parameters: one ulp.
    params_after = plain.model.state_dict()
    for name, d_plain in steps[1].items():
        err = float((steps[0][name] - d_plain).abs().max())
        ulp = 2 * 2.0**-23 * float(params_after[name].abs().max())
        assert err <= GRAD_MAX_RTOL["end2end"] * float(d_plain.abs().max()) + ulp + 1e-9, name
    assert any(steps[0][n].abs().max() > 0 for n in steps[0] if n.endswith("_scale.gamma"))
    fresh = T.build_model(pcfg, "end2end")
    fresh.load_state_dict(served.model.state_dict())
    want = DeviceVolumeScorer(fresh, pcfg.infer, device="cpu").score(vol, 4, 15)
    assert torch.equal(DeviceVolumeScorer(served.model, pcfg.infer, device="cpu").score(vol, 4, 15), want)
    assert torch.equal(first.score(vol, 4, 15), want)  # the first scorer folds anew too
