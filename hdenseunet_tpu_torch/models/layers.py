"""Layer kit of the port (counterpart of hdenseunet_tpu/models/layers.py).

Tensors inside the models are PyTorch-shaped, (N, C, H, W) or
(N, C, H, W, D), and held in ``channels_last`` / ``channels_last_3d`` memory,
which is byte for byte the JAX layout (N, H, W[, D], C); the 3D spatial order
stays the JAX one, (H, W, D). ``channels_last`` restores that format after
an op that may drop it, and costs nothing when the format already holds.

Parameters live in three layer modules whose leaf names are the JAX
pytree's: :class:`Conv` (kernel, bias), :class:`BatchNorm` (gamma, beta and
the moving statistics as buffers) and :class:`Scale` (gamma, beta). Each
records how its leaves are initialised in ``inits``.

A forward takes ``ctx``: None for inference semantics (every BatchNorm uses
its moving statistics, dropout is the identity), or a :class:`Ctx` for
training (the JAX ``Ctx`` under ``train=True``): live BatchNorms normalise
with batch statistics and write their new moving statistics into
``ctx.new_stats``, dropout masks are a hash of ``ctx.seed`` (a tensor on the
device) and each element's index, and ``ctx.remat`` checkpoints every conv
block (:func:`maybe_remat`). Under a data-parallel ``ctx.mesh`` of several
ranks (``core/mesh.py``) each rank holds its rows of the global batch: live
statistics are the global batch's (K6 merges them across ``ctx.group``,
:func:`live_bn`), and each rank's dropout mask is its rows of the mask one
process would draw.

Nothing in a training step reads the device back or draws from a host
generator, so a step can be captured in a CUDA graph and replayed
(``train/trainer.py``), and its backward repeats itself bit for bit: the
3D max pool and the average pools have backwards that sum in a fixed order
(:func:`max_pool`, :func:`avg_pool`), where torch's CUDA backwards add with
atomics.

Inside :func:`count_flops` every :class:`Conv` forward adds its FLOPs to
the open counter, the hook ``utils/flops.py`` counts the real graph with;
the execution forms of the 3D branch (models/s2d.py, zfold.py) add the
direct convolution's through :meth:`Conv.count`.

Numerical-parity notes carried over from the JAX kit:
* encoder convs pad explicitly and symmetrically (ZeroPadding + VALID);
* decoder 'same' convs use the TF split, extra padding at the end;
* max pool pads with zeros, not -inf;
* avg pool sums in float32.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.mesh import axis_group, axis_rank, axis_size
from ..ops import affine_gemm as K5
from ..ops.bn_live import BNLive
from ..ops.dropout import Dropout
from ..ops.fused_affine import AffineReLU, fold_bn_scale

_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}
# The dropout hash (a lowbias32-style mixer): odd multipliers below 2^31, so
# that a 32-bit value times one stays below 2^63 and int64 arithmetic is
# exact on the CPU and on the card alike
_M32 = 0xFFFFFFFF
_MIX = (0x7FEB352D, 0x6A09E667)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit mixer over an int64 tensor of values in [0, 2^32), in
    place on x, which it returns."""
    x.bitwise_xor_(x >> 16)
    x.mul_(_MIX[0]).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 15)
    x.mul_(_MIX[1]).bitwise_and_(_M32)
    return x.bitwise_xor_(x >> 16)


def _host_hash32(v: int) -> int:
    """:func:`hash32` of one Python int."""
    v &= _M32
    v ^= v >> 16
    v = (v * _MIX[0]) & _M32
    v ^= v >> 15
    v = (v * _MIX[1]) & _M32
    return v ^ (v >> 16)


class Ctx:
    """Training state of one forward pass (core/module.py's Ctx under
    ``train=True``).

    ``new_stats`` maps each live :class:`BatchNorm` to its new moving
    (mean, variance). BatchNorm *assigns* its entry, so a conv block that a
    checkpoint recomputes during the backward writes the same values again
    instead of applying the update twice; the trainer copies the dict into
    the buffers after the optimizer step. ``seed`` is the step's seed: an
    int, or a 0-d int64 tensor on ``device`` (the trainer's, so that a
    captured step reads a new seed on every replay); :attr:`seed` gives its
    32-bit hash as a tensor on ``device``. ``remat_policy`` is
    TrainConfig's: 'full' or 'convs' (:func:`maybe_remat`). ``mesh`` is the
    data-parallel mesh the batch is split over, or None; ``group`` and
    ``shard`` are set only when it has several ranks: the process group
    that live statistics reduce over, and (rank, ranks) for dropout.
    """

    def __init__(
        self, seed, *, device, remat: bool = False, remat_policy: str = "full",
        new_stats=None, mesh=None,
    ):
        self.device = torch.device(device)
        self.remat = remat
        self.remat_policy = remat_policy
        self.new_stats = {} if new_stats is None else new_stats
        self.mesh = mesh
        several = axis_size(mesh) > 1
        self.group = axis_group(mesh) if several else None
        self.shard = (axis_rank(mesh), axis_size(mesh)) if several else None
        self._seed = seed
        self._hashed = None
        self._children = 0

    @property
    def seed(self) -> torch.Tensor:
        """This context's 32-bit seed, a 0-d int64 tensor on the device,
        hashed on first use: from the step's seed at the root, from the
        parent's and the child index in a conv block (:meth:`child_seed`)."""
        if self._hashed is None:
            seed = self._seed() if callable(self._seed) else self._seed
            seed = torch.as_tensor(seed, dtype=torch.int64).to(self.device, non_blocking=True)
            self._hashed = hash32((seed ^ (seed >> 32)) & _M32)
        return self._hashed

    def child_seed(self):
        """The seed of the next conv block's context (core/module.py:204-207):
        a function that hashes this context's seed with the block's index on
        the device when a block draws a mask, and not before."""
        self._children += 1
        salt = _host_hash32(self._children)
        return lambda: self.seed ^ salt


def maybe_remat(ctx: Ctx | None, fn, x):
    """``fn(sub_ctx, x)`` for one conv block (core/module.py:187-234).

    The block gets a context of its own: the same ``new_stats``, no remat,
    and a seed derived from this context's (:meth:`Ctx.child_seed`), made
    anew on every run of the block. Under ``ctx.remat`` with autograd on, the
    block runs in a non-reentrant checkpoint: nothing inside it is saved and
    it reruns during the backward, where it draws the same dropout masks and
    assigns the same BatchNorm statistics again. Its parameters are not
    recomputed. Remat on or off, the masks are the same.

    ``ctx.remat_policy == 'convs'`` makes the checkpoint selective
    (core/module.py:222-229): every convolution's output is saved, and only
    the BN/Scale/ReLU/dropout chain between them reruns in the backward, K1
    included; the rerun takes the saved conv outputs instead of convolving.
    """
    if ctx is None:
        return fn(None, x)
    seed = ctx.child_seed()

    def run(x_):
        return fn(Ctx(seed, device=ctx.device, new_stats=ctx.new_stats, mesh=ctx.mesh), x_)

    if not ctx.remat or not torch.is_grad_enabled():
        return run(x)
    kwargs = {}
    if ctx.remat_policy == "convs":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(_save_conv_outputs)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kwargs)


def _save_conv_outputs(_, op, *args, **kwargs):
    """The 'convs' policy: save each convolution's output (the JAX package
    tags it 'conv_out', layers.py:124), recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def channels_last(x):
    """x in channels-last memory for its rank (4 -> 2D, 5 -> 3D)."""
    return x.contiguous(memory_format=_FORMATS[x.dim()])


def tap(taps: dict | None, name: str, x):
    """Record x under ``name`` in ``taps`` (when given) in the JAX package's
    channels-last logical order, (B, H, W[, D], C): a view, no copy."""
    if taps is not None:
        taps[name] = x.movedim(1, -1)


def norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def same_pads(size, kernel, stride):
    """TF 'SAME' padding split for one spatial dim (extra pad at the end)."""
    if size % stride == 0:
        total = max(kernel - stride, 0)
    else:
        total = max(kernel - (size % stride), 0)
    return (total // 2, total - total // 2)


def conv_padding(spatial, kernel, stride, padding):
    """Per-dim (lo, hi) padding for 'same' | 'valid' | int | tuple of ints."""
    n = len(spatial)
    if padding == "same":
        return [same_pads(spatial[i], kernel[i], stride[i]) for i in range(n)]
    if padding == "valid":
        return [(0, 0)] * n
    return [(p, p) for p in norm_tuple(padding, n)]


def _pad_arg(pads):
    """[(lo, hi) per spatial dim] -> F.pad's flat list, last dim first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


class FlopCounter:
    """Conv FLOPs of the forwards run while it is open (:func:`count_flops`):
    ``total``, and per layer name in ``table`` when one is given."""

    def __init__(self, table: dict | None = None):
        self.total = 0.0
        self.table = table

    def add(self, name, flops: float):
        self.total += flops
        if self.table is not None:
            self.table[name] = self.table.get(name, 0.0) + flops


_flop_counter: contextvars.ContextVar[FlopCounter | None] = contextvars.ContextVar(
    "flop_counter", default=None
)


@contextlib.contextmanager
def count_flops(table: dict | None = None):
    """Open a :class:`FlopCounter` for the block, in this thread: every
    :class:`Conv` forward inside adds ``2 * N * prod(out_spatial) *
    features * prod(kernel) * cin`` to it (layers.py:96-106). The
    convolutions still run; on the meta device they run no arithmetic
    (``utils/flops.py``)."""
    counter = FlopCounter(table)
    token = _flop_counter.set(counter)
    try:
        yield counter
    finally:
        _flop_counter.reset(token)


class Conv(nn.Module):
    """N-d convolution (N = 2 or 3), kernel stored (O, I, *k). ``name`` is
    the reference graph's layer name, the key of a FLOP table. ``dilation``
    spaces the kernel's taps (dilated_resnet.py:18-33); padding and the
    output size follow the dilated extent ``(k - 1) * dilation + 1``. The
    dilated network pads ``(k - 1) * dilation // 2`` a side explicitly, as
    the JAX package does, not 'same', whose split can be asymmetric."""

    def __init__(
        self, cin, features, kernel, *, ndim, stride=1, padding="same", dilation=1,
        use_bias=True, init="glorot_uniform", name=None, device=None,
    ):
        super().__init__()
        self.name = name
        self.kernel_size = norm_tuple(kernel, ndim)
        self.stride = norm_tuple(stride, ndim)
        self.dilation = norm_tuple(dilation, ndim)
        self.padding = padding
        self.ndim = ndim
        self.kernel = nn.Parameter(
            torch.empty((features, cin) + self.kernel_size, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty((features,), device=device)) if use_bias else None
        )
        self.inits = {"kernel": init, "bias": "zeros"}

    def forward(self, x, perm=None):
        """``perm``: the canonical axis that each of x's spatial axes holds,
        for a tensor laid out in another spatial order (the d-major (D, H, W)
        is (2, 0, 1), models/dmajor.py). The kernel, stride, dilation and a
        per-axis padding are reordered to x's order; 'same' splits each axis
        as it would in the canonical order."""
        at = (lambda t: t) if perm is None else (lambda t: tuple(t[a] for a in perm))
        ksize, stride, dilation = at(self.kernel_size), at(self.stride), at(self.dilation)
        padding = self.padding if isinstance(self.padding, (str, int)) else at(self.padding)
        # the dilated kernel's extent; the MACs per output stay prod(kernel) * cin
        span = [(k - 1) * d + 1 for k, d in zip(ksize, dilation)]
        pads = conv_padding(x.shape[2:], span, stride, padding)
        out = [
            (s + lo + hi - k) // st + 1 for s, (lo, hi), k, st in zip(x.shape[2:], pads, span, stride)
        ]
        self.count(int(x.shape[0]) * float(np.prod(out)), int(x.shape[1]))
        w = self.kernel.to(x.dtype)
        if perm is not None:
            w = channels_last(w.permute(0, 1, *(2 + a for a in perm)))
        b = None if self.bias is None else self.bias.to(x.dtype)
        conv = F.conv2d if self.ndim == 2 else F.conv3d
        if all(lo == hi for lo, hi in pads):
            y = conv(x, w, b, stride, [lo for lo, _ in pads], dilation)
        else:
            y = conv(channels_last(F.pad(x, _pad_arg(pads))), w, b, stride, 0, dilation)
        return channels_last(y)

    def count(self, outputs: float, cin: int):
        """Add ``2 * outputs * features * prod(kernel) * cin`` to the open
        :func:`count_flops` counter, if any: this layer's useful FLOPs for
        ``outputs`` output positions (batch times spatial), however the
        convolution is executed (models/s2d.py, zfold.py)."""
        counter = _flop_counter.get()
        if counter is not None:
            counter.add(self.name, (
                2.0 * outputs * self.kernel.shape[0] * float(np.prod(self.kernel_size)) * cin
            ))


class BatchNorm(nn.Module):
    """Keras-2.0.8-semantics BatchNormalization (layers.py:142-184).

    With a training ``ctx`` and ``frozen`` False it normalises with the
    batch's float32 mean and biased variance over every axis but channels
    (the global batch's under a mesh of several ranks) through K6
    (:func:`live_bn`), which applies the affine in float32 and rounds once,
    and writes ``momentum*moving + (1-momentum)*batch`` into
    ``ctx.new_stats``. Otherwise (inference, or the hybrid's frozen 2D
    branch) it uses the moving statistics, the affine folded in float32 and
    applied in x's dtype.
    """

    def __init__(self, c, *, eps=1e-3, momentum=0.99, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.gamma = nn.Parameter(torch.empty((c,), device=device))
        self.beta = nn.Parameter(torch.empty((c,), device=device))
        self.register_buffer("moving_mean", torch.empty((c,), device=device))
        self.register_buffer("moving_variance", torch.empty((c,), device=device))
        self.inits = {
            "gamma": "ones", "beta": "zeros",
            "moving_mean": "zeros", "moving_variance": "ones",
        }

    def forward(self, x, ctx: Ctx | None = None, *, frozen: bool = False):
        if ctx is not None and not frozen:
            return live_bn(x, self, None, ctx, relu=False)
        # affine folded in float32, applied in the tensor's own dtype
        inv = torch.rsqrt(self.moving_variance.float() + self.eps) * self.gamma.float()
        shift = self.beta.float() - self.moving_mean.float() * inv
        shape = [1] * x.dim()
        shape[1] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)

    def record(self, ctx: Ctx, mean, var):
        """Assign ``momentum*moving + (1-momentum)*batch`` of the batch's
        mean and biased variance to ``ctx.new_stats``."""
        m = self.momentum
        ctx.new_stats[self] = (
            m * self.moving_mean + (1.0 - m) * mean.detach(),
            m * self.moving_variance + (1.0 - m) * var.detach(),
        )


def live_bn(x, bn: BatchNorm, sc: Scale | None, ctx: Ctx, *, relu: bool):
    """bn with the batch's statistics, then sc when given, then the ReLU
    when ``relu``, as one K6 call (``ops/bn_live.py``: the kernels on the
    card, the plain version on the CPU), whose batch mean and variance bn
    records in ``ctx.new_stats``. Under a mesh of several ranks K6 merges
    the statistics across ``ctx.group``, so they are the global batch's."""
    y, mean, var = BNLive.apply(
        x, bn.gamma, bn.beta, None if sc is None else sc.gamma, None if sc is None else sc.beta,
        bn.eps, relu, ctx.group,
    )
    bn.record(ctx, mean, var)
    return y


def bn_relu(x, bn: BatchNorm, ctx: Ctx | None = None, *, frozen: bool = False):
    """``relu(bn(x, ctx, frozen=frozen))``, the decoders' and the head's
    BN -> ReLU: with live statistics, one K6 call with the ReLU inside
    (:func:`live_bn`)."""
    if ctx is not None and not frozen:
        return live_bn(x, bn, None, ctx, relu=True)
    return torch.relu(bn(x, ctx, frozen=frozen))


class Scale(nn.Module):
    """Per-channel affine ``gamma*x + beta`` (reference lib/custom_layers.py).

    ``folded`` holds the (A, B) pair of this Scale with the BatchNorm before
    it once :meth:`freeze` has folded them; until then it is None. Only
    inference reads it: training folds on every call, so that gradients
    reach the Scale, and drops it once the weights change.
    """

    def __init__(self, c, *, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty((c,), device=device))
        self.beta = nn.Parameter(torch.empty((c,), device=device))
        self.inits = {"gamma": "ones", "beta": "zeros"}
        self.folded = None

    @torch.no_grad()
    def freeze(self, bn: BatchNorm):
        """Fold bn and this Scale once into float32 (A, B) on their device.
        A later change to either layer's weights is not seen."""
        self.folded = fold_bn_scale(
            bn.gamma, bn.beta, bn.moving_mean, bn.moving_variance, self.gamma, self.beta, bn.eps
        )

    def forward(self, x):
        shape = [1] * x.dim()
        shape[1] = -1
        return x * self.gamma.to(x.dtype).view(shape) + self.beta.to(x.dtype).view(shape)


def bn_scale_relu(
    x, bn: BatchNorm, sc: Scale, *, ctx: Ctx | None = None, frozen: bool = False,
    relu_after: bool = True,
):
    """BN -> Scale -> [ReLU] in front of every encoder conv (layers.py:187-222).

    Live statistics (a training ``ctx``, not ``frozen``): one K6 call
    (:func:`live_bn`). Frozen or inference statistics: one folded affine
    through K1 (:class:`AffineReLU`, differentiable into the BN and Scale
    leaves). At inference the pair folded by :meth:`Scale.freeze` is used if
    there is one.
    """
    if ctx is not None and not frozen:
        return live_bn(x, bn, sc, ctx, relu=relu_after)
    a, b = folded_pair(bn, sc, ctx)
    return AffineReLU.apply(x, a, b, relu_after)


def folded_pair(bn: BatchNorm, sc: Scale, ctx: Ctx | None = None):
    """The float32 (A, B) of a frozen bn∘sc: the pair :meth:`Scale.freeze`
    folded, at inference when there is one, else folded now."""
    if ctx is None and sc.folded is not None:
        return sc.folded
    return fold_bn_scale(
        bn.gamma, bn.beta, bn.moving_mean, bn.moving_variance, sc.gamma, sc.beta, bn.eps
    )


def fused_1x1(ctx: Ctx | None) -> bool:
    """Whether a forward takes the fused dense-block route
    (:func:`dense_block`, :func:`bsr_conv1x1`): at inference (``ctx``
    None) with no gradient recorded (``no_grad``/``inference_mode``, as
    every scorer runs), never in training. Every encoder BN∘Scale∘ReLU in
    front of a 1x1 convolution then runs inside K5 (``ops/affine_gemm.py``),
    and so does the one behind a bottleneck; K1 is left where no 1x1
    convolution follows (the stems' and the last block's). Training and an
    inference forward under grad mode keep K1, cuDNN and the concatenation,
    which backpropagate: K5 has no backward, and the block buffer is
    written in place."""
    return ctx is None and not torch.is_grad_enabled()


def bsr_conv1x1(layers, x, base: str, then: str | None = None):
    """At inference, ``layers[base]``, a 1x1 (1x1x1) convolution without
    bias, on the frozen BN∘Scale∘ReLU ``base + '_bn'`` / ``'_scale'`` of
    x, followed by the BN∘Scale∘ReLU ``then`` when given: one K5 launch.
    x (B, K, *S) may be the first K channels of a dense block's buffer.
    The convolution's FLOPs are counted as :meth:`Conv.forward` counts
    them."""
    conv = layers[base]
    assert conv.kernel_size == (1,) * conv.ndim and conv.stride == (1,) * conv.ndim, base
    assert conv.bias is None and x.dim() in (4, 5), base
    k = int(x.shape[1])
    conv.count(float(x.numel() // k), k)
    a1, b1 = folded_pair(layers[base + "_bn"], layers[base + "_scale"])
    a2 = b2 = None
    if then is not None:
        a2, b2 = folded_pair(layers[then + "_bn"], layers[then + "_scale"])
    w = conv.kernel.to(x.dtype).reshape(conv.kernel.shape[0], k)
    return K5.affine_gemm(x, w, a1, b1, a2, b2)


def dense_block(layers, x, prefix: str, nb_layers: int, conv3x3):
    """One dense block at inference in one buffer: x (B, C0, *S) and every
    layer's ``growth`` new channels in a preallocated channels-last (B, C0 +
    nb_layers * growth, *S) tensor, which is returned. Layer ``prefix_b``
    reads channels [0, C) in place through one K5 launch (its x1
    BN∘Scale∘ReLU, 1x1 convolution and x2 BN∘Scale∘ReLU,
    :func:`bsr_conv1x1`), then ``conv3x3(layers[prefix_b_x2], h)`` (the
    layout's 3x3 convolution) writes channels [C, C + growth): the same
    values as the concatenation of the training route, none of its
    copies."""
    growth = int(layers[f"{prefix}_1_x2"].kernel.shape[0])
    c = int(x.shape[1])
    buf = torch.empty((x.shape[0], c + nb_layers * growth, *x.shape[2:]), dtype=x.dtype,
                      device=x.device, memory_format=_FORMATS[x.dim()])
    buf[:, :c] = x
    for branch in range(1, nb_layers + 1):
        base = f"{prefix}_{branch}"
        h = bsr_conv1x1(layers, buf[:, :c], base + "_x1", then=base + "_x2")
        buf[:, c : c + growth] = conv3x3(layers[base + "_x2"], h)
        c += growth
    return buf


def freeze_bn_scale(model: nn.Module):
    """Fold every ``<base>_bn`` / ``<base>_scale`` pair of model's layer
    tables once (:meth:`Scale.freeze`), for serving with final weights."""
    for table in model.modules():
        if isinstance(table, nn.ModuleDict):
            for name, layer in table.items():
                if isinstance(layer, Scale):
                    layer.freeze(table[name.removesuffix("_scale") + "_bn"])
    return model


def prepare_serving(model: nn.Module, device, dtype) -> nn.Module:
    """``model`` readied for scoring, in place: moved to ``device`` in eval
    mode, conv weights cast to ``dtype`` in channels-last memory (BN and
    Scale stay float32, as in the JAX package), every frozen BN∘Scale pair
    folded once (:func:`freeze_bn_scale`), so its weights must be final."""
    model = model.to(device).eval()
    for m in model.modules():
        if isinstance(m, Conv):
            m.to(dtype=dtype, memory_format=_FORMATS[m.ndim + 2])
    return freeze_bn_scale(model)


def unfreeze_bn_scale(model: nn.Module):
    """Drop every folded pair (:meth:`Scale.freeze`): the weights changed."""
    for layer in model.modules():
        if isinstance(layer, Scale):
            layer.folded = None
    return model


def max_pool(x, window, stride, pad=0):
    """Max pool with explicit *zero* padding (Keras ZeroPaddingND + VALID pool).

    The 3D pool's backward is :class:`_MaxPool3d`'s, which repeats itself:
    torch's CUDA backward of ``max_pool3d`` adds with atomics. The 2D one's
    gathers already."""
    nd = x.dim() - 2
    pads = norm_tuple(pad, nd)
    if any(pads):
        x = F.pad(x, _pad_arg([(p, p) for p in pads]))
    window, stride = norm_tuple(window, nd), norm_tuple(stride, nd)
    if nd == 3:
        return channels_last(_MaxPool3d.apply(x, window, stride))
    return channels_last(F.max_pool2d(x, window, stride))


class _MaxPool3d(torch.autograd.Function):
    """VALID ``max_pool3d`` whose backward sums in a fixed order. The
    forward is torch's, ties and all: each window's gradient goes to its
    first maximum in scan order, which the forward's indices name. The
    backward takes each window's offset of that maximum and, offset by
    offset in a fixed order, adds the gradients of the windows whose maximum
    sits there into one strided view of the input gradient, where no two
    windows meet; each input cell so sums its windows' gradients in float32
    (float64 for float64) in the same order on every run, rounded once to
    the input's dtype."""

    @staticmethod
    def forward(ctx, x, window, stride):
        y, idx = F.max_pool3d(x, window, stride, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype, ctx.window, ctx.stride = x.shape, x.dtype, window, stride
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        (kd, kh, kw), (sd, sh, sw) = ctx.window, ctx.stride
        d, h, w = ctx.shape[2:]
        od, oh, ow = g.shape[2:]
        at = lambda n, s, axis: (torch.arange(n, device=g.device) * s).view(
            [n if a == axis else 1 for a in range(3)])
        # the window-local offset of each window's first maximum
        pos = (idx // (h * w) - at(od, sd, 0)) * (kh * kw)
        pos += ((idx // w) % h - at(oh, sh, 1)) * kw
        pos += idx % w - at(ow, sw, 2)
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        dx = torch.empty(ctx.shape, dtype=g.dtype, device=g.device,
                         memory_format=torch.channels_last_3d).zero_()
        zero = g.new_zeros(())
        for p in range(kd * kh * kw):
            a, b, c = p // (kh * kw), (p // kw) % kh, p % kw
            dx[:, :, a:a + sd * (od - 1) + 1:sd, b:b + sh * (oh - 1) + 1:sh,
               c:c + sw * (ow - 1) + 1:sw] += torch.where(pos == p, g, zero)
        return dx.to(ctx.dtype), None, None


def avg_pool(x, window, stride):
    """VALID average pool, summed in float32 (densenet.py:164). The
    windows tile the input (window == stride, as every caller has them), so
    the backward is each window's gradient over its size, copied to its
    cells (:class:`_AvgPool`), which repeats itself: torch's CUDA backward
    of ``avg_pool3d`` adds with atomics."""
    nd = x.dim() - 2
    window, stride = norm_tuple(window, nd), norm_tuple(stride, nd)
    if window != stride:
        raise ValueError(f"avg_pool takes tiling windows, got window {window}, stride {stride}")
    return channels_last(_AvgPool.apply(x, window))


class _AvgPool(torch.autograd.Function):
    """torch's VALID average pool over tiling windows, computed in float32
    (float64 for float64) and rounded to x's dtype; the backward divides the
    output gradient by the window's size in the same precision, as torch's
    does, and spreads it over each window (zero on the cells no window
    covers)."""

    @staticmethod
    def forward(ctx, x, window):
        pool = F.avg_pool2d if len(window) == 2 else F.avg_pool3d
        ctx.shape, ctx.dtype, ctx.window = x.shape, x.dtype, window
        return pool(x.to(torch.promote_types(x.dtype, torch.float32)), window, window).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        dx = upsample_nearest(g / float(np.prod(ctx.window)), ctx.window)
        tail = [s - o for s, o in zip(ctx.shape[2:], dx.shape[2:])]
        if any(tail):
            dx = channels_last(F.pad(dx, _pad_arg([(0, t) for t in tail])))
        return dx.to(ctx.dtype), None


def upsample_nearest(x, factors):
    """Nearest-neighbour upsample by integer per-axis factors, in one copy
    that lands in channels-last memory."""
    nd = x.dim() - 2
    factors = norm_tuple(factors, nd)
    y = x.movedim(1, -1)  # (N, *S, C), contiguous for channels-last x
    n, *spatial, c = y.shape
    y = y.reshape([n] + [v for s in spatial for v in (s, 1)] + [c])
    y = y.expand([n] + [v for s, f in zip(spatial, factors) for v in (s, f)] + [c])
    y = y.reshape([n] + [s * f for s, f in zip(spatial, factors)] + [c])
    return y.movedim(-1, 1)


def dropout(x, rate: float, seed: torch.Tensor | int | None = None, *, shard=None):
    """Inverted dropout (Keras core.py Dropout): each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate). Active only in
    training, i.e. given a seed (a 0-d int64 tensor on x's device, as
    :attr:`Ctx.seed` gives it, or an int); else the identity.

    Element i of x's memory (the batch axis outermost) is kept when the top
    24 bits of ``hash32(seed mod 2^32 ^ i)`` fall below ``(1 - rate) *
    2^24``: the mask is computed on the device from the seed alone, the
    same in eager steps and in a captured graph, remat on or off. K7
    (``ops/dropout.Dropout``) draws it again in the backward and keeps
    none.

    ``shard`` (rank, ranks): x is rank's block of rows of a batch split over
    ``ranks`` processes, and i counts from the rank's first element in the
    whole batch: the rank's rows of the mask one process would draw, and
    only those are computed."""
    if seed is None or rate <= 0.0:
        return x
    n = x.numel()
    if not _dense(x):
        raise ValueError("dropout needs x dense in memory")
    offset = 0
    if shard is not None:
        rank, ranks = shard
        if x.dim() and x.shape[0] > 1 and x.stride(0) * x.shape[0] != n:
            raise ValueError("dropout over a split batch needs the batch axis outermost in memory")
        offset = rank * n
    if offset + n > 2**32:
        raise ValueError("dropout indexes at most 2^32 elements")
    return Dropout.apply(x, torch.as_tensor(seed, dtype=torch.int64, device=x.device), rate, offset)


def _dense(x) -> bool:
    """Whether x's elements fill its memory, in some order of its axes."""
    expect = 1
    for size, stride in sorted(zip(x.shape, x.stride()), key=lambda t: t[1]):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def maybe_dropout(ctx: Ctx | None, x, rate: float):
    """:func:`dropout` with the training context's seed; the identity at
    inference or at rate 0 (no seed is hashed for it)."""
    if ctx is None or rate <= 0.0:
        return x
    if ctx.shard is None:
        return dropout(x, rate, ctx.seed)
    return dropout(x, rate, ctx.seed, shard=ctx.shard)
