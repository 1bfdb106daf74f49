"""``TrainConfig.remat_policy='convs'`` in the port on CPU: each conv
block's checkpoint saves its convolutions' outputs, and only the
BN/Scale/ReLU/dropout chain between them reruns in the backward
(hdenseunet_tpu/core/module.py:222-229).

The 'convs' step is held to the JAX package's 'convs' step at
test_torch_train.py's tolerances, and to the port's own 'full' step and
its step without remat: the same arithmetic in the same order, so the
same loss, gradients and BN statistics.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_train as TT
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops import fused_affine as K
from test_torch_train import assert_step_matches, jax_init, jax_step, make_batch, port_step

_configs = TT.configs


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inits():
    return {arch: jax_init(arch) for arch in ("2d", "end2end")}


def _policy(monkeypatch, policy):
    """test_torch_train's configs, both packages under ``policy``."""
    def configs(arch):
        cfg, pcfg = _configs(arch)
        cfg.train.remat_policy = pcfg.train.remat_policy = policy
        return cfg, pcfg

    monkeypatch.setattr(TT, "configs", configs)


@pytest.mark.parametrize("arch", ["end2end"])
def test_convs_step_matches_jax_convs_step(inits, arch, monkeypatch):
    """On the batch of test_torch_train_hybrid.py's step parity test, at its
    bar: each package's 'convs' step equals its own 'full' step bit for bit
    here (the 2D stage's: test_convs_step_equals_the_full_step_and_no_remat)."""
    params, state = inits[arch]
    batch = make_batch(arch, seed=1)
    _policy(monkeypatch, "convs")
    want = jax_step(arch, params, state, batch)
    st, loss = port_step(arch, params, state, batch, monkeypatch)
    assert_step_matches(arch, want, st, loss, params)


class _Ops(TorchDispatchMode):
    """Counts the convolutions the dispatcher sees."""

    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.convs += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _step(inits, arch, monkeypatch, *, remat, policy):
    """One port step: (state, loss, convolutions run, K1 forward calls, K1
    backward calls)."""
    params, state = inits["2d" if arch == "2d" else "end2end"]
    _policy(monkeypatch, policy)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = K.affine_relu, K.affine_relu_backward

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(K, "affine_relu", counted("fwd", fwd))
    monkeypatch.setattr(K, "affine_relu_backward", counted("bwd", bwd))
    with _Ops() as ops:
        st, loss = port_step(arch, params, state, make_batch(arch, seed=4), monkeypatch, remat=remat)
    monkeypatch.setattr(K, "affine_relu", fwd)
    monkeypatch.setattr(K, "affine_relu_backward", bwd)
    return st, loss, ops.convs, calls["fwd"], calls["bwd"]


def _assert_same_step(a, b):
    (st_a, loss_a, *_), (st_b, loss_b, *_) = a, b
    assert loss_a == loss_b
    for (name, x), (_, y) in zip(P.layers(st_a.model).items(), P.layers(st_b.model).items()):
        for leaf, t in x.named_parameters(recurse=False):
            u = getattr(y, leaf)
            assert (t.grad is None) == (u.grad is None), (name, leaf)
            if t.grad is not None:
                torch.testing.assert_close(u.grad, t.grad, rtol=1e-6, atol=1e-8)
            torch.testing.assert_close(u, t, rtol=1e-6, atol=1e-8)
        for leaf, t in x.named_buffers(recurse=False):
            assert torch.equal(getattr(y, leaf), t), (name, leaf)


@pytest.mark.parametrize("arch", ["2d", "3dpart", "end2end"])
def test_convs_step_equals_the_full_step_and_no_remat(inits, arch, monkeypatch):
    """Loss, gradients, updated parameters and BN statistics of the 'convs'
    step equal the 'full' step's and the un-rematerialised step's. 'convs'
    runs each convolution once, as no remat does; 'full' reruns the blocks'
    convolutions that its backward needs."""
    off = _step(inits, arch, monkeypatch, remat=False, policy="full")
    full = _step(inits, arch, monkeypatch, remat=True, policy="full")
    convs = _step(inits, arch, monkeypatch, remat=True, policy="convs")
    _assert_same_step(convs, full)
    _assert_same_step(convs, off)
    assert convs[2] == off[2] < full[2]


def test_convs_reruns_k1_once_per_call_in_the_blocks(inits, monkeypatch):
    """end2end's frozen 2D BN∘Scale∘ReLU goes through K1: under 'convs' each
    block's K1 calls rerun in the backward as under 'full' (one call each, as
    the forward's), and K1's backward runs once per forward call."""
    off = _step(inits, "end2end", monkeypatch, remat=False, policy="full")
    full = _step(inits, "end2end", monkeypatch, remat=True, policy="full")
    convs = _step(inits, "end2end", monkeypatch, remat=True, policy="convs")
    bsr_in_blocks = 2 * sum(convs[0].model.net2d.blocks)
    assert convs[3] == full[3] == off[3] + bsr_in_blocks
    assert convs[4] == full[4] == off[4] == off[3]


def test_convs_writes_bn_statistics_once(inits, monkeypatch):
    """Every live BN of the 2D stage's conv blocks runs twice under 'convs'
    (the forward and the rerun) and assigns its new moving statistics both
    times: the statistics after the step are the un-rematerialised step's,
    one momentum update, not two."""
    runs = {}
    record = L.BatchNorm.record  # every live BN assigns its statistics here

    def counted(bn, ctx, mean, var):
        runs[bn] = runs.get(bn, 0) + 1
        return record(bn, ctx, mean, var)

    monkeypatch.setattr(L.BatchNorm, "record", counted)
    st, *_ = convs = _step(inits, "2d", monkeypatch, remat=True, policy="convs")
    twice = {bn for bn, n in runs.items() if n == 2}
    assert len(twice) == 2 * sum(st.model.blocks) and set(runs.values()) == {1, 2}
    runs.clear()
    off = _step(inits, "2d", monkeypatch, remat=False, policy="full")
    assert set(runs.values()) == {1}
    params, state = inits["2d"]
    for (name, x), (_, y) in zip(P.layers(convs[0].model).items(), P.layers(off[0].model).items()):
        if isinstance(x, L.BatchNorm):
            assert torch.equal(x.moving_mean, y.moving_mean) and torch.equal(x.moving_variance, y.moving_variance)
            assert not torch.equal(x.moving_mean, torch.tensor(state[name]["moving_mean"])), name


def test_dropout_masks_under_convs_are_the_forwards(inits):
    """With block and decoder dropout live, the 'convs' rerun redraws the
    forward's masks (each block from its own child seed): loss and
    gradients equal the un-rematerialised pass's."""
    params, state = inits["2d"]
    x = torch.from_numpy(make_batch("2d", seed=3)["image"])
    out = []
    for ctx in (L.Ctx(5, device="cpu"), L.Ctx(5, device="cpu", remat=True, remat_policy="convs")):
        model = P.from_numpy(TT.T.build_model(_configs("2d")[1], "2d"), params, state)
        _, logits = model(x, ctx, decoder_dropout=0.3, block_dropout=0.2)
        loss = (logits.float() ** 2).mean()
        loss.backward()
        out.append((loss.item(), {n: t.grad for n, t in model.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=1e-6, atol=1e-8)
