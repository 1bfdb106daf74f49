"""Layer kit of the port (counterpart of hdenseunet_tpu/models/layers.py).

Tensors inside the models are PyTorch-shaped, (N, C, H, W) or
(N, C, H, W, D), and held in ``channels_last`` / ``channels_last_3d`` memory,
which is byte for byte the JAX layout (N, H, W[, D], C); the 3D spatial order
stays the JAX one, (H, W, D). ``channels_last`` restores that format after
an op that may drop it, and costs nothing when the format already holds.

Parameters live in three layer modules whose leaf names are the JAX
pytree's: :class:`Conv` (kernel, bias), :class:`BatchNorm` (gamma, beta and
the moving statistics as buffers) and :class:`Scale` (gamma, beta). Each
records how its leaves are initialised in ``inits``. Only the inference
semantics are ported: BatchNorm always uses its moving statistics and dropout
is the identity.

Numerical-parity notes carried over from the JAX kit:
* encoder convs pad explicitly and symmetrically (ZeroPadding + VALID);
* decoder 'same' convs use the TF split, extra padding at the end;
* max pool pads with zeros, not -inf;
* avg pool sums in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_affine import affine_relu, fold_bn_scale

_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}


def channels_last(x):
    """x in channels-last memory for its rank (4 -> 2D, 5 -> 3D)."""
    return x.contiguous(memory_format=_FORMATS[x.dim()])


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


class Conv(nn.Module):
    """N-d convolution (N = 2 or 3), kernel stored (O, I, *k)."""

    def __init__(
        self, cin, features, kernel, *, ndim, stride=1, padding="same",
        use_bias=True, init="glorot_uniform", device=None,
    ):
        super().__init__()
        self.kernel_size = norm_tuple(kernel, ndim)
        self.stride = norm_tuple(stride, ndim)
        self.padding = padding
        self.ndim = ndim
        self.kernel = nn.Parameter(
            torch.empty((features, cin) + self.kernel_size, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty((features,), device=device)) if use_bias else None
        )
        self.inits = {"kernel": init, "bias": "zeros"}

    def forward(self, x):
        pads = conv_padding(x.shape[2:], self.kernel_size, self.stride, self.padding)
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        conv = F.conv2d if self.ndim == 2 else F.conv3d
        if all(lo == hi for lo, hi in pads):
            y = conv(x, w, b, self.stride, [lo for lo, _ in pads])
        else:
            y = conv(channels_last(F.pad(x, _pad_arg(pads))), w, b, self.stride)
        return channels_last(y)


class BatchNorm(nn.Module):
    """Keras-semantics BatchNormalization with frozen (moving) statistics."""

    def __init__(self, c, *, eps=1e-3, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty((c,), device=device))
        self.beta = nn.Parameter(torch.empty((c,), device=device))
        self.register_buffer("moving_mean", torch.empty((c,), device=device))
        self.register_buffer("moving_variance", torch.empty((c,), device=device))
        self.inits = {
            "gamma": "ones", "beta": "zeros",
            "moving_mean": "zeros", "moving_variance": "ones",
        }

    def forward(self, x):
        # affine folded in float32, applied in the tensor's own dtype
        inv = torch.rsqrt(self.moving_variance.float() + self.eps) * self.gamma.float()
        shift = self.beta.float() - self.moving_mean.float() * inv
        shape = [1] * x.dim()
        shape[1] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class Scale(nn.Module):
    """Per-channel affine ``gamma*x + beta`` (reference lib/custom_layers.py).

    ``folded`` holds the (A, B) pair of this Scale with the BatchNorm before
    it once :meth:`freeze` has folded them; until then it is None.
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


def bn_scale_relu(x, bn: BatchNorm, sc: Scale, *, relu_after: bool = True):
    """Frozen BN -> Scale -> [ReLU] as one folded affine through K1; the pair
    is folded here unless :meth:`Scale.freeze` has folded it already."""
    if sc.folded is None:
        a, b = fold_bn_scale(
            bn.gamma, bn.beta, bn.moving_mean, bn.moving_variance, sc.gamma, sc.beta, bn.eps
        )
    else:
        a, b = sc.folded
    return affine_relu(x, a, b, relu=relu_after)


def freeze_bn_scale(model: nn.Module):
    """Fold every ``<base>_bn`` / ``<base>_scale`` pair of model's layer
    tables once (:meth:`Scale.freeze`), for serving with final weights."""
    for table in model.modules():
        if isinstance(table, nn.ModuleDict):
            for name, layer in table.items():
                if isinstance(layer, Scale):
                    layer.freeze(table[name.removesuffix("_scale") + "_bn"])
    return model


def max_pool(x, window, stride, pad=0):
    """Max pool with explicit *zero* padding (Keras ZeroPaddingND + VALID pool)."""
    nd = x.dim() - 2
    pads = norm_tuple(pad, nd)
    if any(pads):
        x = F.pad(x, _pad_arg([(p, p) for p in pads]))
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    return channels_last(pool(x, norm_tuple(window, nd), norm_tuple(stride, nd)))


def avg_pool(x, window, stride):
    """VALID average pool, summed in float32 (densenet.py:164)."""
    nd = x.dim() - 2
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    y = pool(x.float(), norm_tuple(window, nd), norm_tuple(stride, nd))
    return channels_last(y.to(x.dtype))


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


def dropout(x, rate: float):
    """Inference dropout: the identity (training arrives with the trainer)."""
    del rate
    return x
