"""K1 (hdenseunet_tpu_torch.ops.fused_affine) against the JAX package.

The plain version is held against JAX's ``affine_relu`` run through the
Pallas kernel in interpret mode; the CUDA kernel against the plain version on
the card. The card tests take the ``cuda`` fixture and skip without a card.
JAX is imported inside the fixture that needs it, so the card tests also run
where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_ops.py -k cuda
"""
import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.ops import build
from hdenseunet_tpu_torch.ops import fused_affine as K


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    from hdenseunet_tpu.ops import fused_affine

    return fused_affine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(rows, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (rows, c)).astype(np.float32)
    scale = (1 + 0.5 * rng.normal(size=c)).astype(np.float32)
    shift = (0.5 * rng.normal(size=c)).astype(np.float32)
    return x, scale, shift


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", [(1000, 36), (777, 96), (1, 96)])
def test_plain_matches_jax_pallas_interpret(jax_ops, rows, c, dtype, relu):
    import jax.numpy as jnp

    x, scale, shift = _case(rows, c)
    want = jax_ops.affine_relu(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(shift), relu=relu, interpret=True
    )
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = K.affine_relu_reference(xt, torch.from_numpy(scale), torch.from_numpy(shift), relu=relu)
    assert got.dtype == xt.dtype
    got = got.float().numpy()
    if dtype == "float32":
        # same fp32 arithmetic; XLA may contract the multiply-add: 1 fp32 ulp of x*A
        tol = 2.0**-23 * (np.abs(x * scale) + np.abs(want))
    else:
        # JAX rounds x*A to bf16 before the add, the port rounds once: 1 bf16
        # ulp of the product plus 1 of the result
        xa = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) * np.asarray(
            jnp.asarray(scale, jnp.bfloat16).astype(jnp.float32)
        )
        tol = 2.0**-7 * (np.abs(xa) + np.abs(want))
    assert np.all(np.abs(got - want) <= tol + 1e-30)


def test_plain_is_per_channel_on_axis_1():
    """Channels on axis 1 of a channels-last tensor, as the models hold them."""
    x, scale, shift = _case(2 * 4 * 5, 36)
    nhwc = torch.from_numpy(x).view(2, 4, 5, 36)
    got = K.affine_relu(nhwc.movedim(-1, 1), torch.from_numpy(scale), torch.from_numpy(shift))
    want = K.affine_relu_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift)
    )
    np.testing.assert_array_equal(got.movedim(1, -1).reshape(-1, 36).numpy(), want.numpy())


def test_fold_bn_scale_matches_jax(jax_ops):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=40).astype(np.float32) for _ in range(6)]
    leaves[3] = np.abs(leaves[3]) + 0.1  # a variance
    for eps in (1.1e-5, 1e-3):
        a_j, b_j = jax_ops.fold_bn_scale(*map(jnp.asarray, leaves), eps)
        a_t, b_t = K.fold_bn_scale(*map(torch.from_numpy, leaves), eps)
        # float32 rsqrt and products; XLA may contract multiply-adds
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=2e-6, atol=1e-6)


def test_cpu_tensor_takes_plain_path_without_counting():
    x, scale, shift = _case(64, 96)
    before = K.affine_relu.launches
    got = K.affine_relu(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift))
    want = K.affine_relu_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift)
    )
    assert K.affine_relu.launches == before
    assert torch.equal(got, want)


def test_other_devices_raise():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.affine_relu(x, torch.ones(8), torch.zeros(8))


def test_rows_contiguous_and_vector_path_rules():
    x = torch.zeros(2, 4, 5, 96).movedim(-1, 1)  # channels-last (2, 96, 4, 5)
    assert K.rows_contiguous(x)
    assert not K.rows_contiguous(x.contiguous())  # NCHW memory
    a = torch.zeros(96)
    assert K.vector_path(x, x, a, a)  # bf16/fp32 widths 8/4 both divide 96
    odd = torch.zeros(2, 3, 36, dtype=torch.bfloat16).movedim(-1, 1)
    assert not K.vector_path(odd, odd, torch.zeros(36), torch.zeros(36))
    shifted = torch.zeros(1 + 96 * 3, dtype=torch.bfloat16)[1:].view(3, 96)
    assert not K.vector_path(shifted, shifted, a, a)


def test_library_path_names_the_sources_hash():
    so = build.library_path()
    assert so.parent == build.BUILD_DIR and so.suffix == ".so"
    assert so == build.library_path()
    assert (build.CSRC / "fused_affine.cu").exists()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((36, 64, 64, 96), torch.bfloat16),  # vector path
        ((8, 32, 32, 2, 192), torch.bfloat16),  # 3D, vector path
        ((36, 64, 64, 36), torch.bfloat16),  # C % 8 != 0: scalar path
        ((36, 32, 32, 96), torch.float32),  # vector path
        ((8, 32, 32, 35), torch.float32),  # scalar path
    ],
)
def test_cuda_kernel_matches_plain(cuda, shape, dtype, relu):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (2 * torch.randn(shape, device=cuda, generator=g)).to(dtype).movedim(-1, 1)
    scale = 1 + 0.5 * torch.randn(shape[-1], device=cuda, generator=g)
    shift = 0.5 * torch.randn(shape[-1], device=cuda, generator=g)
    before = K.affine_relu.launches
    got = K.affine_relu(x, scale, shift, relu=relu)
    want = K.affine_relu_reference(x, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert K.affine_relu.launches == before + 1
    assert got.stride() == x.stride()
    a = scale.to(dtype).float().view([1, -1] + [1] * (x.dim() - 2))
    # 1 ulp of the result plus 1 fp32 ulp of x*A (fused multiply-add)
    bound = torch.finfo(dtype).eps * want.float().abs() + 2.0**-23 * (x.float() * a).abs()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_cuda_kernel_raises_on_layout_and_dtype(cuda):
    x = torch.zeros(2, 8, 4, 4, device=cuda)  # NCHW memory, not channels-last
    with pytest.raises(ValueError, match="channels-last"):
        K.affine_relu(x, torch.ones(8, device=cuda), torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        K.affine_relu(
            torch.zeros(4, 8, device=cuda, dtype=torch.float16),
            torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
        )
