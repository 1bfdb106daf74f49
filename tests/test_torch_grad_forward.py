"""The inference forward (``ctx`` None) under grad mode: it backpropagates.

The fused dense-block route (one K5 launch a bottleneck and transition,
the block buffer written in place, ``layers.dense_block``) runs only when
no gradient is recorded (``layers.fused_1x1``). A grad-mode inference
forward takes the concatenation route, K1 through ``AffineReLU`` with its
backward, and so is differentiable as the JAX package's inference forward
is (``hdenseunet_tpu/ops/fused_affine.py:95-110``). On the CPU, tiny
preset, float32:

- the tiny DenseUNet2D and the tiny DenseUNet3D in its shipped
  ``hwdc_s2d`` form, the same weights on both sides (the parameter bridge)
  and the same numpy-seeded input: the input gradient of the summed
  outputs against ``jax.grad`` of the JAX package's inference forward
  within the goldens' bar (tests/test_goldens.py:20);
- the grad-mode outputs equal the ``no_grad`` forward's (the K5 route)
  bit for bit, and K5 is not called under grad mode.

The card test, that K5 refuses an input that requires grad under grad
mode, is ``test_torch_affine_gemm.py::test_cuda_k5_refuses_grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdenseunet_tpu.core.module import Ctx
from hdenseunet_tpu.models import denseunet2d as J2, denseunet3d as J3
from hdenseunet_tpu_torch.core import params as P
from hdenseunet_tpu_torch.models import denseunet2d as T2, denseunet3d as T3
from hdenseunet_tpu_torch.ops import affine_gemm as K5

# the goldens' bar (tests/test_goldens.py:20): float32 sums in another order
# than XLA's, a few ulps of each layer's accumulated magnitude
TOL = dict(atol=2e-4, rtol=1e-4)
CASES = {
    "2d": (J2, T2.DenseUNet2D, (2, 32, 32, 3), {}),
    "3d_hwdc_s2d": (J3, T3.DenseUNet3D, (1, 32, 32, 8, 4), dict(stem_s2d=True)),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _weights(ref, shape, seed):
    """JAX (params, state) of the tiny preset, its BN and Scale leaves moved
    off their identity initialisers with numpy, so that every folded pair
    is more than a plain ReLU."""
    kw = dict(input_size=shape[1], **ref.PRESETS["tiny"])
    if len(shape) == 5:
        kw.update(input_cols=shape[3], channels=shape[4])
    params, state = ref.init(jax.random.key(seed), **kw)
    rng = np.random.default_rng(seed)
    noise = dict(gamma=(1, 0.2), beta=(0, 0.2), moving_mean=(0, 0.2))

    def move(tree):
        out = {}
        for layer, leaves in tree.items():
            out[layer] = {}
            for leaf, v in leaves.items():
                v = np.asarray(v, np.float32)
                if leaf in noise:
                    v = rng.normal(*noise[leaf], v.shape).astype(np.float32)
                elif leaf == "moving_variance":
                    v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                out[layer][leaf] = v
        return out

    return move(params), move(state)


@pytest.mark.parametrize("case", list(CASES))
def test_grad_mode_inference_forward_backpropagates_like_jax(monkeypatch, case):
    ref, net, shape, kw = CASES[case]
    params, state = _weights(ref, shape, seed=len(shape))
    model = P.from_numpy(net(**ref.PRESETS["tiny"]), params, state).eval()
    x = np.random.default_rng(21).normal(0, 50, shape).astype(np.float32)

    calls = []
    real = K5.affine_gemm
    monkeypatch.setattr(K5, "affine_gemm", lambda *a: calls.append(torch.is_grad_enabled()) or real(*a))
    with torch.no_grad():
        served = model(torch.from_numpy(x), **kw)
    assert calls and not any(calls)  # the served forward runs K5, outside grad mode
    calls.clear()

    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, **kw)
    assert not calls  # no K5 under grad mode: the concatenation route
    assert all(torch.equal(a.detach(), b) for a, b in zip(out, served))
    sum(o.sum() for o in out).backward()

    def loss(v):
        return sum(o.sum() for o in ref.apply(Ctx(params, state, train=False), v, **ref.PRESETS["tiny"], **kw))

    want = jax.jit(jax.grad(loss))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
