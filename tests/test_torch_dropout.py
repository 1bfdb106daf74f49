"""K7, a training step's inverted dropout (``ops/dropout.py``,
``csrc/dropout.cu``), and the program's dropout rule it computes.

On the CPU: the plain version's output is x / keep * mask with the mask
``hdu_bench/reference/models.dropout_keep`` states, bit for bit, over 2D
and 3D channels-last tensors in float32 and bfloat16, one rank or a batch
split over 2 or 4; its backward is autograd's of that expression, bit for
bit, for an output gradient in x's memory order or another; ``Dropout``
saves no tensor of more than one element; a step counts one ``dropout``;
a CUDA tensor the kernel cannot take is refused. On the card (the
``cuda`` fixture): the kernel's output and gradient are the ATen chain's
bits at the graphed training cells' shapes, at sizes that leave a tail
past the last 16-byte vector, from a misaligned base, at offsets near
2^32; a captured graph whose seed tensor is rewritten between replays
draws each replay's mask as an eager call does.
"""
from __future__ import annotations

import pytest
import torch

from hdenseunet_tpu_torch.core.initializers import init_model
from hdenseunet_tpu_torch.models import denseunet2d
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops import dropout as K
from hdenseunet_tpu_torch.utils import profiling
from hdu_bench.reference.models import dropout_keep

SEED = 3_500_000_006  # a step seed past 2^31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    """t's bit patterns, so that -0.0 and 0.0 (and NaNs) are told apart."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def _channels_last(shape, dtype, seed=0):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)
    return L.channels_last(x.contiguous(memory_format={4: torch.channels_last, 5: torch.channels_last_3d}[len(shape)]))


def _reference_mask(shape, rate, dtype):
    """dropout_keep's mask over the memory order (N, *spatial, C), as an
    (N, C, *spatial) view."""
    n, c, *spatial = shape
    keep = dropout_keep(SEED, n * c * int(torch.tensor(spatial).prod()), rate, "cpu").to(dtype)
    return keep.view(n, *spatial, c).movedim(-1, 1)


SHAPES = [(4, 6, 5, 7), (4, 6, 5, 3, 4)]


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
def test_plain_path_is_the_reference_rule(shape, dtype, rate, ranks):
    """Each rank's rows through ``Dropout`` (offset: the rows' first element
    in the whole batch), stacked, are x / keep * mask with dropout_keep's
    mask over the whole batch, bit for bit."""
    x = _channels_last(shape, dtype)
    seed = L.Ctx(SEED, device="cpu").seed
    rows = shape[0] // ranks
    got = torch.cat([
        K.Dropout.apply(x[r * rows:(r + 1) * rows], seed, rate, r * x[:rows].numel()) for r in range(ranks)
    ])
    want = x / (1.0 - rate) * _reference_mask(shape, rate, dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("g_layout", ["x's", "contiguous"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
def test_backward_is_autograd_of_the_chain(shape, dtype, rate, g_layout):
    """dx of ``Dropout`` equals autograd's dx of x / keep * mask bit for
    bit, the output gradient in x's memory order or in another."""
    x = _channels_last(shape, dtype)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    if g_layout == "x's":
        g = torch.empty_like(x).copy_(g)
    seed = L.Ctx(SEED, device="cpu").seed
    xr = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(K.Dropout.apply(xr, seed, rate, 0), xr, g)
    xw = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(xw / (1.0 - rate) * _reference_mask(shape, rate, dtype), xw, g)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
def test_saves_no_tensor_of_more_than_one_element(shape):
    """A forward through ``layers.maybe_dropout`` keeps the 0-d seed for
    its backward and nothing else: no mask, no activation."""
    x = _channels_last(shape, torch.bfloat16).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = L.maybe_dropout(L.Ctx(SEED, device="cpu"), x, 0.3)
    assert saved and max(saved) <= 1, saved
    y.float().sum().backward()
    assert torch.equal(x.grad != 0, y != 0)  # the backward drew the forward's mask again


def _dropout_count(model, x, remat):
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, logits = model(x, L.Ctx(0, device=x.device, remat=remat), decoder_dropout=0.3)
        logits.float().sum().backward()
    counts = profiling.snapshot()["counts"]
    profiling.reset()
    return counts.get("dropout", 0)


@pytest.mark.parametrize("remat", [False, True])
def test_a_step_counts_one_dropout(remat):
    """``dropout`` (read by the benchmark's ``dropout_calls.eager``): one a
    2D training step, the decoder's, which no checkpoint recomputes; the
    tiny network on the CPU and DenseUNet-167 at d167.train.*'s batch of 10
    x 224x224x3 on the meta device."""
    tiny = init_model(denseunet2d.DenseUNet2D(**denseunet2d.PRESETS["tiny"]), 0)
    assert _dropout_count(tiny, torch.randn((2, 32, 32, 3)), remat) == 1
    full = denseunet2d.DenseUNet2D(device="meta")
    x = torch.empty((10, 224, 224, 3), device="meta", dtype=torch.bfloat16)
    assert _dropout_count(full, x, remat) == 1


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA card."""

    @property
    def is_cpu(self):
        return False

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["float64", "seed of two"])
def test_cuda_tensor_the_kernel_cannot_take_raises(case):
    """A CUDA tensor in a dtype the kernel has no form for, or a seed that
    is not one int64 on its device, is refused before any launch: there is
    no fallback to the plain version."""
    dtype, seed = {"float64": (torch.float64, torch.tensor(7)),
                   "seed of two": (torch.float32, torch.tensor([7, 8]))}[case]
    x = torch.randn((2, 8, 4, 4), dtype=dtype).as_subclass(_CudaLike)
    with pytest.raises(TypeError if case == "float64" else ValueError):
        K.dropout_forward(x, seed, 0.3)


# --- on the card ------------------------------------------------------------

# (shape, dtype, rate, offset, misaligned): hdu.train.end2end's head and
# d167.train.*'s decoder dropout, sizes that leave a tail past the last
# 16-byte vector, a base one element past a 16-byte boundary (the scalar
# path), offsets that end at 2^32, float32 cases.
CARD_CASES = [
    ((8, 64, 224, 224, 8), torch.bfloat16, 0.3, 0, False),
    ((10, 64, 224, 224), torch.bfloat16, 0.3, 0, False),
    ((10, 64, 224, 224), torch.float32, 0.1, 0, False),
    ((3, 5, 7, 11), torch.bfloat16, 0.3, 0, False),
    ((3, 5, 7, 11, 2), torch.float32, 0.1, 0, False),
    ((4, 9, 33, 17), torch.bfloat16, 0.3, 0, True),
    ((4, 9, 33, 17), torch.float32, 0.3, 0, True),
    ((2, 7, 13, 5), torch.bfloat16, 0.3, 2**32 - 2 * 7 * 13 * 5, False),
    ((2, 64, 40, 40, 3), torch.float32, 0.1, 2**32 - 2 * 64 * 40 * 40 * 3, False),
]


def _card_x(shape, dtype, misaligned, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = int(torch.tensor(shape).prod())
    flat = (3 * torch.randn(n + 1, device=device, generator=gen)).to(dtype)
    if misaligned:
        return flat[1:].view(shape)  # NCHW-contiguous, its base 2 or 4 bytes past 16-byte alignment
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}[len(shape)]
    return flat[:n].view(shape).contiguous(memory_format=fmt)


@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"{'x'.join(map(str, c[0]))}-{str(c[1])[6:]}-"
                         f"r{c[2]}-o{c[3]}-m{int(c[4])}")
def test_cuda_kernel_is_the_aten_chain(cuda, case):
    """K7's y and dx against the chain it replaced run on the card (the
    plain version's arithmetic on CUDA tensors, and autograd of it), bit
    for bit."""
    shape, dtype, rate, offset, misaligned = case
    x = _card_x(shape, dtype, misaligned, cuda, 0)
    g = _card_x(shape, dtype, misaligned, cuda, 1)
    assert (x.data_ptr() % 16 != 0) == misaligned
    seed = L.Ctx(SEED, device=cuda).seed
    xr = x.detach().requires_grad_()
    y = K.Dropout.apply(xr, seed, rate, offset)
    (dx,) = torch.autograd.grad(y, xr, g)
    xw = x.detach().requires_grad_()
    want = K.dropout_reference(xw, seed, rate, offset)
    (want_dx,) = torch.autograd.grad(want, xw, g)
    torch.cuda.synchronize()
    assert y.stride() == x.stride() and dx.stride() == x.stride()
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(dx), _bits(want_dx))


def test_cuda_graph_replay_draws_each_seed(cuda):
    """``Dropout`` forward and backward captured in a CUDA graph; the seed
    tensor rewritten before each replay: each replay gives the eager call's
    bits for that seed, and two seeds give two masks."""
    shape = (10, 64, 56, 56)
    x = _card_x(shape, torch.bfloat16, False, cuda, 0)
    g = _card_x(shape, torch.bfloat16, False, cuda, 1)
    seed = torch.zeros((), dtype=torch.int64, device=cuda)

    def step():
        xr = x.detach().requires_grad_()
        y = K.Dropout.apply(xr, seed, 0.3, 0)
        return (y, *torch.autograd.grad(y, xr, g))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()  # warm up outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = step()
    torch.cuda.current_stream().wait_stream(stream)
    masks = []
    for s in (L.Ctx(SEED, device=cuda).seed, L.Ctx(SEED + 1, device=cuda).seed):
        seed.copy_(s)
        graph.replay()
        got = [t.clone() for t in out]
        want = step()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
        masks.append(got[0] != 0)
    assert not torch.equal(masks[0], masks[1])
