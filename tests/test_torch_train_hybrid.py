"""One train step of each hybrid stage ('3dpart', 'end2end') of the port
against the JAX package's, on CPU: loss, every trainable gradient, the new
BN moving statistics and the parameters after the SGD update. Tolerances and
helpers are test_torch_train.py's (the 2D stage's step is there)."""
import pytest
import torch

from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.train import trainer as T
from test_torch_train import (
    GRAD_MAX_RTOL, assert_step_matches, jax_init, jax_step, make_batch, port_state, port_step,
)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hybrid_init():
    return jax_init("end2end")


@pytest.fixture(scope="module", params=["3dpart", "end2end"])
def stage(request, hybrid_init):
    params, state = hybrid_init
    batch = make_batch(request.param, seed=1)
    return request.param, batch, jax_step(request.param, params, state, batch)


def test_train_step_matches_jax(hybrid_init, stage, monkeypatch):
    arch, batch, want = stage
    params, state = hybrid_init
    st, loss = port_step(arch, params, state, batch, monkeypatch)
    assert_step_matches(arch, want, st, loss, params)


def test_frozen_2d_branch_is_untouched(hybrid_init, stage, monkeypatch):
    """The hybrid's 2D BN statistics never move; in '3dpart' no 2D leaf
    takes a gradient, in 'end2end' the 2D convs and Scales do."""
    arch, batch, _ = stage
    params, state = hybrid_init
    st, _ = port_step(arch, params, state, batch, monkeypatch)
    net2d = st.model.net2d
    for name, layer in net2d.items():
        for leaf, t in layer.named_buffers(recurse=False):
            assert torch.equal(t, torch.tensor(state[name][leaf])), (name, leaf)
    grads = {n: t.grad for n, t in net2d.named_parameters()}
    if arch == "3dpart":
        assert all(g is None for g in grads.values())
    else:
        assert grads["conv1.kernel"] is not None and grads["conv1_scale.gamma"] is not None
        assert grads["conv1_bn.gamma"] is None and grads["bn_up0.beta"] is None


def test_float32_summation_order_moves_hybrid_gradients(hybrid_init, monkeypatch):
    """Why the hybrid steps hold gradients to GRAD_MAX_RTOL (5e-2) of each
    tensor's largest entry, and chip_smoke.py its tiny card-against-CPU step
    to 5e-2 of each update's norm: two float32 end2end steps of the port
    itself, which differ only in the convolutions' summation order (conv
    kernels in contiguous against channels-last memory), already differ by
    far more than an elementwise 1e-4 (2.6 % of a 2D Scale's largest
    gradient when written): the 2D branch's gradients come back through the
    x250 fusion and 3D BNs that see 4 values per channel at this size.
    Tensors whose largest gradient is below 1e-4 (conv biases in front of a
    live BN: zero in exact arithmetic) are left out. Run with -s to see the
    gaps."""
    params, state = hybrid_init
    batch = make_batch("end2end", seed=1)
    monkeypatch.setattr(L, "dropout", lambda x, rate, seed=None: x)
    steps = []
    for channels_last in (False, True):
        st, pcfg = port_state("end2end", params, state)
        if channels_last:
            for m in st.model.modules():
                if isinstance(m, L.Conv):
                    fmt = torch.channels_last if m.ndim == 2 else torch.channels_last_3d
                    m.kernel.data = m.kernel.data.contiguous(memory_format=fmt)
        T.train_step(st, batch, pcfg)
        steps.append(dict(st.model.named_parameters()))
    max_rel, norm_rel = {}, {}
    for name, x in steps[0].items():
        if x.grad is None or float(x.grad.abs().max()) <= 1e-4:
            continue
        diff = (x.grad - steps[1][name].grad).abs()
        max_rel[name] = float(diff.max() / x.grad.abs().max())
        norm_rel[name] = float(diff.norm() / x.grad.norm())
    worst_max, worst_norm = max(max_rel.values()), max(norm_rel.values())
    print(f"float32 summation order: gradients apart by up to {worst_max:.3g} of a tensor's "
          f"largest entry and {worst_norm:.3g} of its norm")
    assert 1e-4 < worst_max < GRAD_MAX_RTOL["end2end"] and worst_norm < 5e-2
