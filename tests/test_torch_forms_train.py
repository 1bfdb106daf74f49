"""Training through the 3D branch's execution forms, on CPU in float32: a
3dpart and an end2end step in the d-major layout and with the
space-to-depth stem against the JAX package's step in the same form, and
the 3D branch's gradients in every form against ``jax.grad``.

Weights come from the port's seeded initializer, with every BN and Scale
leaf and moving statistic redrawn from a seed (at their initial values a
frozen BN∘Scale maps 0 to exactly 0, where JAX's ReLU splits the gradient
and K1's mask does not, in every form alike), and reach the JAX package as
its pytree. Dropout is the identity in both packages, as in
test_torch_train.py, whose helpers and step bars this file shares: the live
3D BNs of a hybrid step make its float32 gradients hang on summation order
(JAX's own d-major and canonical steps differ by about 1 % of a tensor's
largest gradient), so a step is held to GRAD_MAX_RTOL; with frozen
statistics the branch's gradients are held to 2e-4 of each tensor's
largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.module import Ctx as JCtx
from hdenseunet_tpu.models import denseunet3d as J3
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.models import denseunet3d as T3, hybrid as TH
from hdenseunet_tpu_torch.models import layers as L
from test_torch_train import (
    _torch_layout, assert_step_matches, jax_step, make_batch, port_step,
)

GRAD_RTOL = 2e-4  # frozen statistics: of each tensor's largest gradient
BRANCH_FORMS = {
    "hwdc": {},
    "dhwc": dict(layout="dhwc"),
    "hwdc_s2d": dict(stem_s2d=True),
    "dhwc_s2d": dict(layout="dhwc", stem_s2d=True),
    "fold_z": dict(fold_z=True),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _redraw_affines(model, seed):
    """The model's JAX pytree with every BN/Scale gamma and beta and every
    moving statistic drawn from ``seed``, loaded into the model too."""
    params, state = P.to_numpy(model)
    rng = np.random.default_rng(seed)
    for leaves in params.values():
        for leaf in ("gamma", "beta"):
            if leaf in leaves:
                mean = 1.0 if leaf == "gamma" else 0.0
                leaves[leaf] = rng.normal(mean, 0.2, leaves[leaf].shape).astype(np.float32)
    for leaves in state.values():
        leaves["moving_mean"] = rng.normal(0, 0.2, leaves["moving_mean"].shape).astype(np.float32)
        leaves["moving_variance"] = rng.uniform(0.5, 2.0, leaves["moving_variance"].shape).astype(np.float32)
    P.from_numpy(model, params, state)
    return params, state


@pytest.fixture(scope="module")
def hybrid_init():
    return _redraw_affines(init_model(TH.HDenseUNet(preset="tiny"), 0), 3)


@pytest.mark.parametrize(
    "arch,form",
    [("3dpart", dict(layout3d="dhwc")), ("3dpart", dict(stem_s2d=True)),
     ("end2end", dict(layout3d="dhwc")), ("end2end", dict(stem_s2d=True)),
     ("end2end", dict(layout3d="dhwc", stem_s2d=True))],
    ids=["3dpart-dhwc", "3dpart-s2d", "end2end-dhwc", "end2end-s2d", "end2end-dhwc-s2d"],
)
def test_train_step_in_each_form_matches_jax(hybrid_init, arch, form, monkeypatch):
    """ModelConfig.layout3d and stem_s2d reach the hybrid stages: loss,
    gradients, moving statistics and the update against JAX's
    _forward_loss in the same form."""
    params, state = hybrid_init
    batch = make_batch(arch, seed=1)
    want = jax_step(arch, params, state, batch, **form)
    st, loss = port_step(arch, params, state, batch, monkeypatch, **form)
    assert_step_matches(arch, want, st, loss, params)


@pytest.fixture(scope="module")
def branch_init():
    model = init_model(T3.DenseUNet3D(**T3.PRESETS["tiny"]), 8)
    params, state = _redraw_affines(model, 4)
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, 32, 32, 8, 4)).astype(np.float32)
    g = rng.normal(0, 1, (2, 32, 32, 8, 3)).astype(np.float32)
    return model, (params, state), x, g


@pytest.mark.parametrize("form", list(BRANCH_FORMS))
def test_branch_gradients_match_jax_in_each_form(branch_init, form):
    """With frozen statistics, the gradients of every leaf and of the input
    through each form (the repacked s2d and tap-packed kernels, the
    permuted d-major ones) against jax.grad of denseunet3d.apply in the same
    form, under a random cotangent of the logits."""
    model, (params, state), x, g = branch_init
    kw = BRANCH_FORMS[form]

    def jax_loss(p, v):
        _, logits = J3.apply(JCtx(p, state), v, bn_frozen=True, **kw, **J3.PRESETS["tiny"])
        return jnp.sum(logits * g)

    want_p, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    model.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    _, logits = model(xt, L.Ctx(0, device="cpu"), bn_frozen=True, **kw)
    (logits * torch.from_numpy(g)).sum().backward()
    for name, layer in P.layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            want = _torch_layout(leaf, want_p[name][leaf])
            got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
            tol = GRAD_RTOL * np.abs(want).max() + 1e-9
            assert np.abs(got - want).max() <= tol, (name, leaf, np.abs(got - want).max(), tol)
    want_x = np.asarray(want_x)
    assert np.abs(xt.grad.numpy() - want_x).max() <= GRAD_RTOL * np.abs(want_x).max()

