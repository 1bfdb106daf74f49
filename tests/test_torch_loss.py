"""The port's loss wrappers (hdenseunet_tpu_torch.train.loss) against
hdenseunet_tpu.train.loss on the same logits and labels, value and gradient,
on CPU (the plain K2 pair against JAX's XLA reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdenseunet_tpu.train import loss as JLoss
from hdenseunet_tpu_torch.train import loss as TLoss


def _case(shape, seed, keepdim):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, shape + (3,)).astype(np.float32)
    labels = rng.integers(0, 3, shape + ((1,) if keepdim else ())).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize(
    "kind,shape",
    [("2d", (2, 16, 16)), ("hybrid", (2, 16, 16, 8)), ("hybrid", (1, 8, 8, 4))],
)
def test_loss_and_gradient_match_jax(kind, shape, keepdim):
    logits, labels = _case(shape, seed=len(shape) * 10 + shape[-1], keepdim=keepdim)
    jfn = getattr(JLoss, f"weighted_crossentropy_{kind}")
    tfn = getattr(TLoss, f"weighted_crossentropy_{kind}")
    loss_j, grad_j = jax.value_and_grad(lambda l: jfn(l, jnp.asarray(labels)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss_t = tfn(lt, torch.from_numpy(labels))
    loss_t.backward()
    # float32 sums over a few thousand voxels in another order
    assert abs(loss_t.item() - float(loss_j)) <= 2e-6 * abs(float(loss_j))
    np.testing.assert_allclose(
        lt.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-6 * float(jnp.abs(grad_j).max())
    )
    if kind == "hybrid":  # the boundary z-slices take no gradient (loss.py:6-7)
        assert not lt.grad[:, :, :, [0, -1]].any() and lt.grad[:, :, :, 1:-1].any()


def test_custom_weights_and_bf16_logits_match_jax():
    logits, labels = _case((2, 16, 16, 8), seed=5, keepdim=False)
    weights = (1.0, 2.0, 0.5)
    want = JLoss.weighted_crossentropy_hybrid(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), weights
    )
    got = TLoss.weighted_crossentropy_hybrid(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
        torch.tensor(weights),
    )
    # both upcast the same bf16 logits to float32
    assert abs(got.item() - float(want)) <= 2e-6 * abs(float(want))
