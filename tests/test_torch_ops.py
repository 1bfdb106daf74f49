"""K1 (hdenseunet_tpu_torch.ops.fused_affine) and K2 (ops.wce) against the
JAX package.

The plain versions are held against JAX's ``affine_relu`` and
``weighted_ce`` run through their Pallas kernels in interpret mode (with
their custom VJPs); the CUDA kernels against the plain versions on the card.
The card tests take the ``cuda`` fixture and skip without a card. JAX is
imported inside the fixtures that need it, so the card tests also run where
JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_ops.py -k cuda
"""
import types

import numpy as np
import pytest
import torch

from hdenseunet_tpu_torch.ops import build, cc, cc_cases
from hdenseunet_tpu_torch.ops import fused_affine as K
from hdenseunet_tpu_torch.ops import wce as W


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


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [35, 36, 96, 192, 2208])
def test_plain_backward_matches_jax_vjp(jax_ops, c, dtype, relu):
    """The port's closed-form backward, given JAX's own forward output y,
    against jax.vjp through the interpret-mode Pallas kernel and its custom
    VJP (fused_affine.py:81-89)."""
    import jax
    import jax.numpy as jnp

    x, scale, shift = _case(613, c, seed=c)
    g = np.random.default_rng(c + 1).normal(size=x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(
        lambda x_, a_, b_: jax_ops.affine_relu(x_, a_, b_, relu=relu, interpret=True),
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(shift),
    )
    dx_j, da_j, db_j = (np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, jdt)))
    tdt = getattr(torch, dtype)
    y_t = torch.from_numpy(np.array(y.astype(jnp.float32))).to(tdt)
    dx, da, db = K.affine_relu_backward_reference(
        torch.from_numpy(g).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
        y_t, relu=relu,
    )
    assert dx.dtype == tdt and da.dtype == db.dtype == torch.float32
    # dx = g*A rounded once in both: exact
    np.testing.assert_array_equal(dx.float().numpy(), dx_j)
    # per-channel sums of 613 rows in float32, in another order, then
    # rounded to the working dtype: a few fp32 ulps of sum |g*x| plus one
    # ulp of the working dtype
    gm = np.where(np.asarray(y_t.float()) > 0, g, 0) if relu else g
    xq = torch.from_numpy(x).to(tdt).float().numpy()
    gq = torch.from_numpy(gm).to(tdt).float().numpy()
    eps = float(torch.finfo(tdt).eps)
    for got, want, mag in ((da, da_j, np.abs(gq * xq).sum(0)), (db, db_j, np.abs(gq).sum(0))):
        tol = 16 * 2.0**-23 * mag + eps * np.abs(want) + 1e-30
        assert np.all(np.abs(got.numpy() - want) <= tol)


def test_autograd_function_on_cpu_runs_the_plain_pair():
    """AffineReLU on CPU tensors: the plain forward, and the plain closed-form
    backward reached through autograd, with no kernel launch."""
    x, scale, shift = _case(6 * 5 * 4, 24, seed=9)
    xt = torch.from_numpy(x).view(6, 5, 4, 24).movedim(-1, 1).requires_grad_()
    a = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(shift).requires_grad_()
    before = (K.affine_relu.launches, K.affine_relu_backward.launches)
    y = K.AffineReLU.apply(xt, a, b, True)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=y.shape).astype(np.float32))
    y.backward(g)
    want = K.affine_relu_backward_reference(g, xt.detach(), a.detach(), y.detach())
    assert torch.equal(xt.grad, want[0]) and torch.equal(a.grad, want[1]) and torch.equal(b.grad, want[2])
    # and equal to autograd through the plain forward chain (float32)
    x2, a2, b2 = (t.detach().clone().requires_grad_() for t in (xt, a, b))
    torch.relu(x2 * a2.view(1, -1, 1, 1) + b2.view(1, -1, 1, 1)).backward(g)
    for got, ref in ((xt.grad, x2.grad), (a.grad, a2.grad), (b.grad, b2.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert (K.affine_relu.launches, K.affine_relu_backward.launches) == before


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
    """A tensor on neither the CPU nor a card, nor the meta device (which
    takes the plain version and computes nothing), raises; a stand-in
    carries the device, since this build makes tensors on no other."""
    x = types.SimpleNamespace(is_cpu=False, is_meta=False, is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device xpu"):
        K.affine_relu(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="unsupported device xpu"):
        K.affine_relu_backward(x, x, torch.ones(8), x)


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
    assert (build.CSRC / "fused_affine.cu").exists() and (build.CSRC / "wce.cu").exists()


# --------------------------------------------------------------------------
# K2: weighted cross-entropy
# --------------------------------------------------------------------------

WEIGHTS = (0.78, 0.65, 8.57)


def _weights(c):
    """WEIGHTS and, past three classes, smaller weights of their own."""
    return WEIGHTS + tuple(0.5 + 0.25 * k for k in range(c - 3))


def _wce_case(n, c=3, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (n, c)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    mask = (rng.uniform(size=n) > 0.25).astype(np.float32) if masked else np.ones(n, np.float32)
    # a clip-active row (tests/test_ops.py::test_wce_clip_active): its
    # label's log-probability is far below ln 1e-10, so it takes no gradient
    logits[0, :3] = (0.0, 40.0, -40.0)
    labels[0], mask[0] = 2, 1.0
    return logits, labels, mask


@pytest.fixture(scope="module")
def jax_wce():
    pytest.importorskip("jax")
    from hdenseunet_tpu.ops import wce

    return wce


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,masked,c",
    [(2048, False, 3), (3000, True, 3), (5, True, 3), (3001, True, 3), (3001, True, 8)],
    ids=["2048-False", "3000-True", "5-True", "3001-True", "3001-True-c8"],
)
def test_plain_wce_matches_jax_pallas_interpret(jax_wce, n, masked, c, dtype):
    import jax
    import jax.numpy as jnp

    logits, labels, mask = _wce_case(n, c, masked=masked, seed=n)
    weights = _weights(c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lj, yj, mj = jnp.asarray(logits, jdt), jnp.asarray(labels), jnp.asarray(mask)
    loss_j = float(jax_wce.weighted_ce(lj, yj, mj, weights, True))
    grad_j = jax.grad(lambda l: jax_wce.weighted_ce(l, yj, mj, weights, True))(lj)
    lt = torch.from_numpy(logits).to(tdt).requires_grad_()
    loss_t = W.weighted_ce(lt, torch.from_numpy(labels), torch.from_numpy(mask), weights)
    loss_t.backward()
    # float32 sums of n terms in another order (the Pallas kernel sums tiles)
    assert abs(loss_t.item() - loss_j) <= 2e-6 * abs(loss_j)
    assert lt.grad.dtype == tdt
    got, want = lt.grad.float().numpy(), np.asarray(grad_j.astype(jnp.float32))
    assert np.all(got[0] == 0) and np.all(want[0] == 0)  # the clip kills row 0's gradient
    # the same float32 closed form, rounded once to the logits' dtype; exp
    # differs by an ulp between the libraries, which p - 1 exposes in full
    eps = float(torch.finfo(tdt).eps)
    atol = 4 * 2.0**-23 * max(weights) / mask.sum()
    np.testing.assert_allclose(got, want, rtol=eps if dtype == "bfloat16" else 1e-5, atol=atol)


def test_wce_plain_pair_is_the_autograd_of_the_plain_forward():
    logits, labels, mask = _wce_case(777, seed=3)
    w = torch.tensor(WEIGHTS)
    lt = torch.from_numpy(logits).requires_grad_()
    W.weighted_ce(lt, torch.from_numpy(labels), torch.from_numpy(mask), w).backward()
    l2 = torch.from_numpy(logits).requires_grad_()
    loss, _ = W.weighted_ce_reference(l2, torch.from_numpy(labels), torch.from_numpy(mask), w)
    loss.backward()  # autograd through clamp_min: no gradient where the clip is active
    np.testing.assert_allclose(lt.grad.numpy(), l2.grad.numpy(), rtol=1e-5, atol=1e-9)


def test_wce_cpu_tensors_take_the_plain_path_without_counting():
    logits, labels, mask = _wce_case(100)
    before = (W.wce_forward.launches, W.wce_backward.launches)
    lt = torch.from_numpy(logits).requires_grad_()
    W.weighted_ce(lt, torch.from_numpy(labels), torch.from_numpy(mask), WEIGHTS).backward()
    assert (W.wce_forward.launches, W.wce_backward.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        W.wce_forward(
            torch.empty((4, 3), device="meta"), torch.empty(4, dtype=torch.int32, device="meta"),
            torch.empty(4, device="meta"), torch.empty(3, device="meta"),
        )


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


def _k1_backward_bound(got, want, g, x, dtype):
    """dx within one ulp of the working dtype; dscale and dshift within one
    ulp of the working dtype plus 256 float32 ulps of sum |g*x| (sum |g|):
    both sum in float32, the kernel in row blocks then in double, the plain
    version in PyTorch's reduction order."""
    eps = torch.finfo(dtype).eps
    dims = [d for d in range(x.dim()) if d != 1]
    gx = (g.float() * x.float()).abs().sum(dims)
    ga = g.float().abs().sum(dims)
    ok = bool(((got[0].float() - want[0].float()).abs() <= eps * want[0].float().abs()).all())
    for k, mag in ((1, gx), (2, ga)):
        bound = eps * want[k].abs() + 256 * 2.0**-23 * mag + 1e-30
        ok = ok and bool(((got[k] - want[k]).abs() <= bound).all())
    return ok


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((8, 28, 28, 96), torch.bfloat16),  # vector path
        ((4, 14, 14, 2208), torch.bfloat16),  # widest DenseNet-161 concat: 9 channel tiles
        ((8, 16, 16, 2, 192), torch.bfloat16),  # 3D
        ((8, 28, 28, 36), torch.bfloat16),  # C % 8 != 0: scalar path
        ((8, 16, 16, 96), torch.float32),  # vector path
        ((8, 16, 16, 35), torch.float32),  # scalar path
    ],
)
def test_cuda_backward_matches_plain(cuda, shape, dtype, relu):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (2 * torch.randn(shape, device=cuda, generator=gen)).to(dtype).movedim(-1, 1)
    g = torch.randn(shape, device=cuda, generator=gen).to(dtype).movedim(-1, 1)
    scale = 1 + 0.5 * torch.randn(shape[-1], device=cuda, generator=gen)
    shift = 0.5 * torch.randn(shape[-1], device=cuda, generator=gen)
    y = K.affine_relu_reference(x, scale, shift, relu=relu)
    before = K.affine_relu_backward.launches
    got = K.affine_relu_backward(g, x, scale, y, relu=relu)
    want = K.affine_relu_backward_reference(g, x, scale, y, relu=relu)
    torch.cuda.synchronize()
    assert K.affine_relu_backward.launches == before + 1
    assert got[0].stride() == x.stride() and got[1].dtype == torch.float32
    assert _k1_backward_bound(got, want, g, x, dtype)
    again = K.affine_relu_backward(g, x, scale, y, relu=relu)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: same bits


def test_cuda_autograd_function_launches_both_kernels(cuda):
    x = torch.randn(4, 16, 16, 96, device=cuda).to(torch.bfloat16).movedim(-1, 1).requires_grad_()
    a = torch.rand(96, device=cuda).requires_grad_()
    b = torch.randn(96, device=cuda).requires_grad_()
    before = (K.affine_relu.launches, K.affine_relu_backward.launches)
    y = K.AffineReLU.apply(x, a, b, True)
    y.float().sum().backward()  # the incoming gradient arrives channels-first
    torch.cuda.synchronize()
    assert (K.affine_relu.launches, K.affine_relu_backward.launches) == (before[0] + 1, before[1] + 1)
    assert x.grad.shape == x.shape and a.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [401_408, 5, 2048 * 3 + 17])
def test_cuda_wce_matches_plain(cuda, n, dtype):
    logits, labels, mask = (torch.from_numpy(a).to(cuda) for a in _wce_case(n, seed=n))
    logits = logits.to(dtype)
    w = torch.tensor(WEIGHTS, device=cuda)
    before = (W.wce_forward.launches, W.wce_backward.launches)
    loss, cnt = W.wce_forward(logits, labels, mask, w)
    loss_p, cnt_p = W.weighted_ce_reference(logits, labels, mask, w)
    g = torch.tensor(1.3, device=cuda)
    d = W.wce_backward(logits, labels, mask, w, cnt, g)
    d_p = W.weighted_ce_backward_reference(logits, labels, mask, w, cnt_p, g)
    torch.cuda.synchronize()
    assert (W.wce_forward.launches, W.wce_backward.launches) == (before[0] + 1, before[1] + 1)
    assert float(cnt) == float(cnt_p)
    # float32 sums of n terms in other orders
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    # the same float32 closed form (exp/log within 2 ulps), one rounding
    eps = torch.finfo(dtype).eps
    bound = eps * d_p.float().abs() + 8 * 2.0**-23 * float(g) * 8.57 / float(cnt_p)
    assert bool(((d.float() - d_p.float()).abs() <= bound).all())
    assert torch.equal(W.wce_forward(logits, labels, mask, w)[0], loss)  # no atomics


def _device_kernels(fn) -> int:
    """Kernels one call of fn launches, counted by torch.profiler after a
    first call (which may make the stream's scratch buffer): the runtime's
    launch calls, which the profiler records on the host. The device's
    kernel events, where the profiler kept any, must agree; it drops a lone
    kernel whose device time stamps it maps outside its window, as it did
    on the card in a process older than some seconds."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
                   for e in events)
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    assert kernels in (0, launches), (kernels, launches)
    return launches


def _k1_backward_case(device, rows, c, dtype, relu=True, seed=0):
    """(g, x, scale, y) as (rows, C) matrices on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.randn((rows, c), device=device, generator=gen)).to(dtype)
    g = torch.randn((rows, c), device=device, generator=gen).to(dtype)
    scale = 1 + 0.5 * torch.randn(c, device=device, generator=gen)
    shift = 0.5 * torch.randn(c, device=device, generator=gen)
    return g, x, scale, K.affine_relu_reference(x, scale, shift, relu=relu)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "rows,c",
    [
        (5, 96),  # fewer rows than one block's row step
        (5, 2208),
        (37, 36),  # C % 8 != 0: scalar path
        (1003, 36),  # rows not a multiple of the unrolled row step
        (1003, 96),
        (4099, 2208),  # nine channel tiles in bf16, eighteen in fp32
    ],
)
def test_cuda_backward_edges_exact_and_deterministic(cuda, rows, c, dtype, relu):
    g, x, scale, y = _k1_backward_case(cuda, rows, c, dtype, relu, seed=rows + c)
    if relu:
        y[rows // 2, c // 3] = float("nan")  # masks its gradient, as jnp.where(y > 0)
    want = K.affine_relu_backward_reference(g, x, scale, y, relu=relu)
    runs = [K.affine_relu_backward(g, x, scale, y, relu=relu) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], want[0])  # dx = g*A rounded once in both
    assert _k1_backward_bound(runs[0], want, g, x, dtype)
    for again in runs[1:]:  # a fixed summation order: the same bits
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


def test_cuda_back_to_back_calls_leave_their_counters_at_zero(cuda):
    """Calls of other shapes queued back to back share the stream's scratch
    counters (K1's backward one per channel tile, K2's forward one): each
    gives the plain version's answer, and the sequence run again the same
    bits, only if every last block set its counter back to zero."""
    cases = [
        _k1_backward_case(cuda, rows, c, torch.bfloat16, seed=c)
        for rows, c in ((4099, 2208), (1003, 96), (777, 36))
    ]
    logits, labels, mask = (torch.from_numpy(a).to(cuda) for a in _wce_case(3001, seed=5))
    w = torch.tensor(WEIGHTS, device=cuda)

    def sequence():
        out = []
        for g, x, scale, y in cases:
            out += [K.affine_relu_backward(g, x, scale, y), W.wce_forward(logits, labels, mask, w)]
        return out

    first, second = sequence(), sequence()
    torch.cuda.synchronize()
    for (g, x, scale, y), got in zip(cases, first[0::2]):
        want = K.affine_relu_backward_reference(g, x, scale, y)
        assert torch.equal(got[0], want[0])
        assert _k1_backward_bound(got, want, g, x, torch.bfloat16)
    loss_p, cnt_p = W.weighted_ce_reference(logits, labels, mask, w)
    for loss, cnt in first[1::2]:
        assert float(cnt) == float(cnt_p)
        assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(first, second):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_cuda_each_call_is_one_kernel(cuda):
    g, x, scale, y = _k1_backward_case(cuda, 4099, 2208, torch.bfloat16, seed=3)
    assert _device_kernels(lambda: K.affine_relu(x, scale, scale)) == 1
    assert _device_kernels(lambda: K.affine_relu_backward(g, x, scale, y)) == 1
    logits, labels, mask = (torch.from_numpy(a).to(cuda) for a in _wce_case(3001, seed=4))
    w = torch.tensor(WEIGHTS, device=cuda)
    _, cnt = W.wce_forward(logits, labels, mask, w)
    one = torch.ones((), device=cuda)
    assert _device_kernels(lambda: W.wce_forward(logits, labels, mask, w)) == 1
    assert _device_kernels(lambda: W.wce_backward(logits, labels, mask, w, cnt, one)) == 1


def _wce_agrees(logits, labels, mask, w, g):
    """K2 forward and backward against their plain versions: the mask's sum
    exact, the loss within float32 sums of n terms in other orders, dlogits
    within the same float32 closed form (exp/log within 2 ulps) rounded once,
    and no gradient on the clip-active row 0."""
    loss, cnt = W.wce_forward(logits, labels, mask, w)
    loss_p, cnt_p = W.weighted_ce_reference(logits, labels, mask, w)
    d = W.wce_backward(logits, labels, mask, w, cnt, g)
    d_p = W.weighted_ce_backward_reference(logits, labels, mask, w, cnt_p, g)
    torch.cuda.synchronize()
    assert float(cnt) == float(cnt_p)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    eps = torch.finfo(logits.dtype).eps
    bound = eps * d_p.float().abs() + 8 * 2.0**-23 * float(g) * float(w.max()) / float(cnt_p)
    assert bool(((d.float() - d_p.float()).abs() <= bound).all())
    assert not d[0].any()
    assert torch.equal(W.wce_forward(logits, labels, mask, w)[0], loss)  # no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 4, 8])
@pytest.mark.parametrize("n", [5, 8, 3001, 3_211_264])
def test_cuda_wce_row_groups_and_classes(cuda, n, c, dtype):
    """Rows 8 at a time with a tail of n % 8 rows, for 3, 4 and 8 classes."""
    logits, labels, mask = (torch.from_numpy(a).to(cuda) for a in _wce_case(n, c, seed=n + c))
    w = torch.tensor(_weights(c), device=cuda)
    _wce_agrees(logits.to(dtype), labels, mask, w, torch.tensor(0.7, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wce_unaligned_logits_take_the_row_path(cuda, dtype):
    logits, labels, mask = (torch.from_numpy(a).to(cuda) for a in _wce_case(3001, seed=6))
    flat = torch.empty(logits.numel() + 1, dtype=dtype, device=cuda)
    shifted = flat[1:].view(logits.shape)  # one element past 16-byte alignment
    shifted.copy_(logits)
    _wce_agrees(shifted, labels, mask, torch.tensor(WEIGHTS, device=cuda), torch.tensor(1.0, device=cuda))


def test_cuda_kernel_raises_on_layout_and_dtype(cuda):
    x = torch.zeros(2, 8, 4, 4, device=cuda)  # NCHW memory, not channels-last
    with pytest.raises(ValueError, match="channels-last"):
        K.affine_relu(x, torch.ones(8, device=cuda), torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        K.affine_relu(
            torch.zeros(4, 8, device=cuda, dtype=torch.float16),
            torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
        )


# --------------------------------------------------------------------------
# K4 (ops.cc) on the card against its plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.05, 0.1, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 1, 7), (17, 9, 33), (64, 48, 40)])
def test_cuda_cc_kernels_match_plain(cuda, shape, p):
    """The labels themselves (component minima), the largest component and
    the hole fill, bit for bit; twice, the same bits."""
    from hdenseunet_tpu_torch.ops import cc

    m = torch.from_numpy(np.random.default_rng(int(p * 100) + sum(shape)).random(shape) < p).to(cuda)
    for conn in (26, 6):
        got = cc.cc_label(m, conn)
        assert torch.equal(got, cc.cc_label_reference(m, conn)), conn
        assert torch.equal(got, cc.cc_label(m, conn))
    assert torch.equal(cc.largest_component(m), cc.largest_component_reference(m))
    assert torch.equal(cc.fill_holes(m), cc.fill_holes_reference(m))


@pytest.mark.parametrize("name", list(cc_cases.cases(tuple(2 * b for b in cc.BRICK))))
def test_cuda_cc_kernels_on_brick_cases(cuda, name):
    """The brick-boundary cases (ops/cc_cases.py) at two bricks an axis:
    labels, largest component and hole fill equal the plain versions."""
    m = torch.from_numpy(cc_cases.cases(tuple(2 * b for b in cc.BRICK))[name]).to(cuda)
    for conn in (26, 6):
        assert torch.equal(cc.cc_label(m, conn), cc.cc_label_reference(m, conn)), conn
    assert torch.equal(cc.largest_component(m), cc.largest_component_reference(m))
    assert torch.equal(cc.fill_holes(m), cc.fill_holes_reference(m))


@pytest.mark.parametrize("p", [0.1, 0.3, 0.6])
@pytest.mark.parametrize("shape", cc_cases.off_by_one_shapes() + cc_cases.off_by_one_shapes((2, 3, 2)))
def test_cuda_cc_kernels_off_a_brick_multiple(cuda, shape, p):
    m = torch.from_numpy(np.random.default_rng(sum(shape)).random(shape) < p).to(cuda)
    for conn in (26, 6):
        assert torch.equal(cc.cc_label(m, conn), cc.cc_label_reference(m, conn)), conn
    assert torch.equal(cc.largest_component(m), cc.largest_component_reference(m))
    assert torch.equal(cc.fill_holes(m), cc.fill_holes_reference(m))


@pytest.mark.parametrize("x0,y0,xp,yp,zs,pack_z", [(16, 16, 16, 16, 16, 16), (30, 21, 32, 32, 64, 24)])
def test_cuda_compose_kernels_match_plain(cuda, x0, y0, xp, yp, zs, pack_z):
    from hdenseunet_tpu_torch.ops import cc

    rng = np.random.default_rng(x0 + pack_z)
    scores = rng.choice(np.array([0, 1, 3], np.uint8), size=(xp, yp, zs), p=[0.6, 0.3, 0.1])
    ext_bits = rng.integers(0, 256, (x0, y0, pack_z // 8), dtype=np.uint8)
    args = (torch.from_numpy(scores).to(cuda), torch.from_numpy(ext_bits).to(cuda))
    got = cc.compose_prep(*args, pack_z=pack_z)
    want = cc.compose_prep_reference(*args, pack_z=pack_z)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for liver, tumor in ((got[0], got[1]), (torch.zeros_like(got[0]), torch.zeros_like(got[1]))):
        for _ in range(2):  # the second call finds the scratch counters reset
            out = cc.compose_finish(liver, tumor)
            ref = cc.compose_finish_reference(liver, tumor)
            assert all(torch.equal(a, b) for a, b in zip(out, ref)), (out[2], ref[2])


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("shape", [(16, 16, 16), (64, 48, 112)] + cc_cases.compose_shapes())
def test_cuda_compose_finish_edges(cuda, shape, offset):
    """compose_finish on the edges of its grid (ops/cc_cases.py): empty and
    full maps, one voxel at each corner, z lengths 4, 8 and 12 modulo 16;
    from a 4-byte storage offset the kernel takes its 4-voxel path. Bit for
    bit against the plain version, twice (the counters reset)."""
    for name, (liver, tumor) in cc_cases.compose_cases(shape, seed=sum(shape)).items():
        args = []
        for a in (liver, tumor):
            flat = torch.zeros(a.size + 16, dtype=torch.bool, device=cuda)
            t = flat[offset:offset + a.size].view(shape)
            t.copy_(torch.from_numpy(a))
            args.append(t)
        want = cc.compose_finish_reference(*args)
        for _ in range(2):
            got = cc.compose_finish(*args)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, got[2], want[2])


@pytest.mark.parametrize("arch", ["2d", "end2end"])
def test_cuda_graphed_steps_equal_eager(cuda, tmp_path, arch):
    """train() at steps_per_dispatch 2, tiny preset, 6 steps on the card
    (a group eager, then two groups replayed from one captured step, dropout
    live) against 6 eager steps, 6 eager steps again, and 4 graphed steps
    resumed for 2 more: losses, parameters, moving statistics and momentum
    buffers bit for bit; K1 and K2 launch inside the capture."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.data.sampler import synthetic_batches
    from hdenseunet_tpu_torch.train import trainer as T

    gen = synthetic_batches(mode="2d" if arch == "2d" else "hybrid", batch=2, input_size=32,
                            input_cols=8, seed=0)
    batches = [next(gen) for _ in range(6)]
    runs = []
    for k in (1, 2, 1):
        cfg = Config()
        cfg.model.preset, cfg.model.input_size, cfg.model.compute_dtype = "tiny", 32, "bfloat16"
        cfg.train.arch, cfg.train.batch, cfg.train.steps_per_dispatch = arch, 2, k
        cfg.train.save_path, cfg.train.log_every_steps = str(tmp_path / str(len(runs))), 1
        before = (K.affine_relu.launches, W.wce_forward.launches)
        state = T.train(cfg, iter(batches), max_steps=6, device="cuda", log_fn=lambda *a: None)
        launched = (K.affine_relu.launches - before[0], W.wce_forward.launches - before[1])
        losses = (tmp_path / str(len(runs)) / "history" / "lossbatch.txt").read_text()
        tensors = [*state.model.state_dict().values(),
                   *(s["momentum_buffer"] for s in state.optimizer.state.values())]
        runs.append((losses, [t.detach().clone() for t in tensors], launched))
    assert runs[1][0] == runs[0][0] == runs[2][0]
    for a, b, c in zip(runs[0][1], runs[1][1], runs[2][1]):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the graphed run's wrappers launched 2 eager steps and 1 captured one
    assert runs[1][2][1] == 3 and runs[0][2][1] == 6
    assert (runs[1][2][0] > 0) == (arch == "end2end")
    # 4 graphed steps, a save, a resume and 2 more equal the 6 eager steps
    cfg.train.steps_per_dispatch, cfg.train.checkpoint_every_steps = 2, 4
    T.train(cfg, iter(batches[:4]), max_steps=4, device="cuda", checkpoint_dir=str(tmp_path / "ck"),
            log_fn=lambda *a: None)
    state = T.train(cfg, iter(batches[4:]), max_steps=2, device="cuda", resume=True,
                    checkpoint_dir=str(tmp_path / "ck"), log_fn=lambda *a: None)
    resumed = [*state.model.state_dict().values(),
               *(s["momentum_buffer"] for s in state.optimizer.state.values())]
    assert state.step == 6 and all(torch.equal(a, b) for a, b in zip(runs[0][1], resumed))
