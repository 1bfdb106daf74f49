"""Plain PyTorch reference of H-DenseUNet (arXiv 1709.07330) and of its 2D
stage, DenseUNet-167, written from the published networks (reference
repository: denseunet.py / densenet.py for the 2D DenseUNet-167,
denseunet3d.py for the 3D DenseNet, hybridnet.py:355-423 for the x250
fusion and the HFF head).

Nothing here imports the program under test. The parameters are a flat
``{key: tensor}`` dict whose keys are the reference graph's layer names
(``conv2_1_x1.kernel``, ``3dconv1_bn.moving_mean``, ``fianl_conv.bias``
[sic]); :func:`layer_table` lists every key with its shape and how the
benchmark draws it. Tensors are (N, C, H, W) and, in 3D, (N, C, H, W, D),
contiguous; each convolution goes through an ``ops`` object, so one forward
serves the float32 reference (:class:`Float32Ops`), the lower-precision
control (:class:`Fp8Ops`) and the work count on the meta device
(``work/counts.py``).

The layer equations, as the reference graph has them:

* encoder: BN(eps 1.1e-5) -> Scale -> ReLU in front of every convolution;
  the stems are 7x7(x7) stride 2 with 3 zero padding a side, followed by a
  3x3(x3) stride-2 max pool over 1 zero padding a side; a dense layer is a
  1x1 bottleneck of 4 x growth channels and a 3x3 of growth channels, its
  output concatenated to its input; a transition is a 1x1 convolution to
  half the channels and a 2x2 (2x2x1 in 3D) average pool; the last block
  ends in BN -> Scale -> ReLU;
* 2D decoder: five times nearest 2x upsample -> 3x3 conv with bias -> BN
  (eps 1e-3) -> ReLU, dropout before the fifth BN in training, then a 1x1
  classifier; its input to the classifier is the 2D feature map;
* 3D decoder: upsample by (2,2,1) three times and (2,2,2) twice, each a
  3x3x3 conv with bias -> BN -> ReLU; its last map is the 3D feature map;
* hybrid: each z slice's stack [z-1, z, z+1] (replicated at the window's
  ends) through the 2D network; the 2D logits times 250 beside the volume
  as the 3D input; the HFF head adds the two feature maps, then 3x3x3 conv
  -> BN -> ReLU -> 1x1x1 classifier.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
_MIX = (0x7FEB352D, 0x6A09E667)


# --------------------------------------------------------------------------
# the parameter table
# --------------------------------------------------------------------------


def _encoder(table, prefix, cin, spec, ndim):
    """Layer table of one DenseNet encoder; returns its output channels."""
    k = lambda n: (n,) * ndim
    f0, growth = spec["initial_filters"], spec["growth"]

    def conv(name, ci, co, kern, init="glorot", bias=False):
        table.append((f"{name}.kernel", (co, ci) + k(kern), init))
        if bias:
            table.append((f"{name}.bias", (co,), "bias"))

    def bn_scale(base, c):
        table.append((f"{base}_bn.gamma", (c,), "gamma"))
        table.append((f"{base}_bn.beta", (c,), "beta"))
        table.append((f"{base}_bn.moving_mean", (c,), "mean"))
        table.append((f"{base}_bn.moving_variance", (c,), "var"))
        table.append((f"{base}_scale.gamma", (c,), "gamma"))
        table.append((f"{base}_scale.beta", (c,), "beta"))

    conv(f"{prefix}conv1", cin, f0, 7)
    bn_scale(f"{prefix}conv1", f0)
    c = f0
    blocks = spec["blocks"]
    for bi, n in enumerate(blocks):
        stage = bi + 2
        for br in range(1, n + 1):
            base = f"{prefix}conv{stage}_{br}"
            bn_scale(f"{base}_x1", c)
            conv(f"{base}_x1", c, 4 * growth, 1)
            bn_scale(f"{base}_x2", 4 * growth)
            conv(f"{base}_x2", 4 * growth, growth, 3)
            c += growth
        bn_scale(f"{prefix}conv{stage}_blk", c)
        if bi < len(blocks) - 1:
            out = int(c * (1.0 - spec["reduction"]))
            conv(f"{prefix}conv{stage}_blk", c, out, 1)
            c = out
    return c


def _bn(table, name, c):
    table.append((f"{name}.gamma", (c,), "gamma"))
    table.append((f"{name}.beta", (c,), "beta"))
    table.append((f"{name}.moving_mean", (c,), "mean"))
    table.append((f"{name}.moving_variance", (c,), "var"))


def table_2d(spec, num_classes, prefix=""):
    """[(key, shape, init)] of DenseUNet-167 (``spec``: the configuration's
    2D widths); ``prefix`` is prepended to every key."""
    t: list = []
    c = _encoder(t, "", spec["in_channels"], spec, 2)
    for i, w in enumerate(spec["decoder_widths"]):
        t.append((f"conv_up{i}.kernel", (w, c, 3, 3), "normal"))
        t.append((f"conv_up{i}.bias", (w,), "bias"))
        _bn(t, f"bn_up{i}", w)
        c = w
    t.append(("dense167classifer.kernel", (num_classes, c, 1, 1), "normal"))
    t.append(("dense167classifer.bias", (num_classes,), "bias"))
    return [(prefix + key, shape, init) for key, shape, init in t]


def table_3d(spec, num_classes, prefix=""):
    """[(key, shape, init)] of the hybrid's 3D DenseNet branch."""
    t: list = []
    c = _encoder(t, "3d", 1 + num_classes, spec, 3)
    for i, w in enumerate(spec["decoder_widths"]):
        t.append((f"3dconv_up{i}.kernel", (w, c, 3, 3, 3), "glorot"))
        t.append((f"3dconv_up{i}.bias", (w,), "bias"))
        _bn(t, f"3dbn_up{i}", w)
        c = w
    t.append(("3dclassifer.kernel", (num_classes, c, 1, 1, 1), "glorot"))
    t.append(("3dclassifer.bias", (num_classes,), "bias"))
    return [(prefix + key, shape, init) for key, shape, init in t]


def layer_table(cfg) -> list:
    """Every parameter and statistic of the configuration's model, keyed as
    the reference graph names them: the 2D stage's bare names, or the
    hybrid's under ``net2d.``, ``net3d.`` and ``head.``."""
    nc = cfg["num_classes"]
    if cfg["model"] == "denseunet2d":
        return table_2d(cfg["net2d"], nc)
    head = cfg["head_width"]
    width = cfg["net3d"]["decoder_widths"][-1]
    t = table_2d(cfg["net2d"], nc, "net2d.") + table_3d(cfg["net3d"], nc, "net3d.")
    t.append(("head.fianl_conv.kernel", (head, width, 3, 3, 3), "glorot"))
    t.append(("head.fianl_conv.bias", (head,), "bias"))
    _bn(t, "head.final_bn", head)
    t.append(("head.2d3dclassifer.kernel", (nc, head, 1, 1, 1), "glorot"))
    t.append(("head.2d3dclassifer.bias", (nc,), "bias"))
    return t


def glorot_limit(shape) -> float:
    receptive = math.prod(shape[2:])
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))


# --------------------------------------------------------------------------
# convolution back ends
# --------------------------------------------------------------------------


class Float32Ops:
    """float32 convolutions (the caller turns TF32 off); activations kept as
    they are."""

    def conv(self, x, w, b, stride, pad, name=None):
        fn = F.conv2d if x.dim() == 4 else F.conv3d
        return fn(x, w, b, stride, pad)

    def act(self, x):
        return x


def _quantize(t, dtype):
    """Round t to ``dtype`` (a float8 type) under one per-tensor scale that
    maps its largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Q8(torch.autograd.Function):
    """Forward: rounded to float8 e4m3; backward: the gradient rounded to
    float8 e5m2, as float8 training rounds both passes' operands."""

    @staticmethod
    def forward(ctx, t):
        return _quantize(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, torch.float8_e5m2)


class Bf16Ops(Float32Ops):
    """The reference in the configuration's own precision: every
    convolution in bfloat16 on bfloat16 operands (float32 sums), its output
    and every post-BN activation rounded to bfloat16."""

    def conv(self, x, w, b, stride, pad, name=None):
        half = None if b is None else b.bfloat16()
        return super().conv(x.bfloat16(), w.bfloat16(), half, stride, pad).float()

    def act(self, x):
        return x.bfloat16().float()


class Fp8Ops(Float32Ops):
    """The control: float8 wherever the program computes in bfloat16. Every
    convolution's input, weights and output and every activation after a
    BatchNorm are rounded to float8 e4m3 (a per-tensor scale), products
    accumulate and statistics are taken in float32, and in the backward each
    of those tensors' gradients is rounded to float8 e5m2."""

    def conv(self, x, w, b, stride, pad, name=None):
        return _Q8.apply(super().conv(_Q8.apply(x), _Q8.apply(w), b, stride, pad))

    def act(self, x):
        return _Q8.apply(x)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _cshape(x):
    return [1, -1] + [1] * (x.dim() - 2)


def batch_norm(x, P, name, eps, train=None):
    """Keras BatchNormalization: the batch's mean and biased variance over
    every axis but channels in training (recorded in ``train.stats``), the
    moving statistics otherwise."""
    if train is not None:
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = ((x - mean.view(_cshape(x))) ** 2).mean(dims)
        train.stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[f"{name}.moving_mean"], P[f"{name}.moving_variance"]
    s = _cshape(x)
    y = (x - mean.view(s)) / torch.sqrt(var.view(s) + eps)
    return y * P[f"{name}.gamma"].view(s) + P[f"{name}.beta"].view(s)


def bn_scale_relu(ops, x, P, base, eps, train=None):
    y = batch_norm(x, P, f"{base}_bn", eps, train)
    s = _cshape(x)
    return ops.act(torch.relu(y * P[f"{base}_scale.gamma"].view(s) + P[f"{base}_scale.beta"].view(s)))


def conv(ops, x, P, name, stride=1, pad=0):
    return ops.conv(x, P[f"{name}.kernel"], P.get(f"{name}.bias"), stride, pad, name=name)


def max_pool_zero_pad(x):
    """3x3(x3) stride-2 max pool after 1 zero of padding a side."""
    nd = x.dim() - 2
    x = F.pad(x, [1, 1] * nd)
    return (F.max_pool2d if nd == 2 else F.max_pool3d)(x, 3, 2)


def upsample(x, factors):
    for axis, f in enumerate(factors):
        if f > 1:
            x = x.repeat_interleave(f, dim=2 + axis)
    return x


def encoder(ops, x, P, spec, eps, prefix, train=None, *, pool3d=(2, 2, 1)):
    """The DenseNet encoder through the last block's BN-Scale-ReLU."""
    x = conv(ops, x, P, f"{prefix}conv1", stride=2, pad=3)
    x = max_pool_zero_pad(bn_scale_relu(ops, x, P, f"{prefix}conv1", eps, train))
    blocks = spec["blocks"]
    for bi, n in enumerate(blocks):
        stage = bi + 2
        for br in range(1, n + 1):
            base = f"{prefix}conv{stage}_{br}"
            h = conv(ops, bn_scale_relu(ops, x, P, f"{base}_x1", eps, train), P, f"{base}_x1")
            h = conv(ops, bn_scale_relu(ops, h, P, f"{base}_x2", eps, train), P, f"{base}_x2", pad=1)
            x = torch.cat([x, h], dim=1)
        x = bn_scale_relu(ops, x, P, f"{prefix}conv{stage}_blk", eps, train)
        if bi < len(blocks) - 1:
            x = conv(ops, x, P, f"{prefix}conv{stage}_blk")
            x = F.avg_pool2d(x, 2) if x.dim() == 4 else F.avg_pool3d(x, pool3d)
    return x


def dropout_keep(seed: int, n: int, rate: float, device) -> torch.Tensor:
    """The benchmark's statement of the program's dropout rule (a (n,)
    float32 0/1 mask over the memory order (N, H, W, C)): a step's seed s
    becomes h(s xor s >> 32 mod 2^32), and element i is kept when the top 24
    bits of h(i xor that) fall below round((1 - rate) 2^24); h is the
    lowbias32 mixer with multipliers 0x7FEB352D and 0x6A09E667."""

    def mix(v):
        v = v ^ (v >> 16)
        v = (v * _MIX[0]) & M32
        v = v ^ (v >> 15)
        v = (v * _MIX[1]) & M32
        return v ^ (v >> 16)

    s = torch.tensor(seed, dtype=torch.int64, device=device)
    s = mix((s ^ (s >> 32)) & M32)
    h = mix(torch.arange(n, dtype=torch.int64, device=device) ^ s)
    return ((h >> 8) < round((1.0 - rate) * 2**24)).float()


class TrainStep:
    """A training forward's state: live statistics land in ``stats``; the
    decoder's dropout draws from ``seed`` at ``rate``."""

    def __init__(self, seed: int, rate: float):
        self.seed, self.rate, self.stats = seed, rate, {}


def forward_2d(ops, x, P, cfg, train=None, prefix=""):
    """DenseUNet-167: x (N, 3, H, W) -> (features (N, F, H, W), logits (N, C, H, W))."""
    spec = cfg["net2d"]
    Q = P if not prefix else {k[len(prefix):]: v for k, v in P.items() if k.startswith(prefix)}
    x = encoder(ops, x, Q, spec, spec["eps_encoder"], "", train)
    for i in range(len(spec["decoder_widths"])):
        x = conv(ops, upsample(x, (2, 2)), Q, f"conv_up{i}", pad=1)
        if i == len(spec["decoder_widths"]) - 1 and train is not None and train.rate > 0:
            keep = dropout_keep(train.seed, x.numel(), train.rate, x.device)
            mask = keep.view(x.shape[0], x.shape[2], x.shape[3], x.shape[1]).permute(0, 3, 1, 2)
            x = x / (1.0 - train.rate) * mask
        x = ops.act(torch.relu(batch_norm(x, Q, f"bn_up{i}", spec["eps_decoder"], train)))
    return x, conv(ops, x, Q, "dense167classifer")


def features_3d(ops, x, P, cfg):
    """The 3D branch at inference: x (N, 1 + C, H, W, D) -> its last decoder
    map (N, F, H, W, D). Its own classifier feeds nothing and is not run."""
    spec = cfg["net3d"]
    Q = {k[len("net3d."):]: v for k, v in P.items() if k.startswith("net3d.")}
    x = encoder(ops, x, Q, spec, spec["eps_encoder"], "3d")
    for i, f in enumerate(spec["upsample"]):
        x = conv(ops, upsample(x, f), Q, f"3dconv_up{i}", pad=1)
        x = ops.act(torch.relu(batch_norm(x, Q, f"3dbn_up{i}", spec["eps_decoder"])))
    return x


def hff_head(ops, feat3d, fea2d, P, cfg):
    """HFF: the sum of the feature maps -> 3x3x3 conv -> BN -> ReLU -> 1x1x1."""
    Q = {k[len("head."):]: v for k, v in P.items() if k.startswith("head.")}
    f = conv(ops, feat3d + fea2d, Q, "fianl_conv", pad=1)
    f = ops.act(torch.relu(batch_norm(f, Q, "final_bn", cfg["net3d"]["eps_decoder"])))
    return conv(ops, f, Q, "2d3dclassifer")


def fuse(ops, vol, res2d, fea2d, P, cfg):
    """The hybrid after its 2D branch: vol (N, 1, H, W, D), the 2D logits
    and features (N, C|F, H, W, D) -> logits (N, C, H, W, D)."""
    x = torch.cat([vol, res2d * cfg["logit_amplification"]], dim=1)
    return hff_head(ops, features_3d(ops, x, P, cfg), fea2d, P, cfg)


def window_stacks(d: int) -> list:
    """The 2D input of each of a window's d slices: (prev, cur, next)
    offsets within the window, replicated at its ends."""
    return [(max(p - 1, 0), p, min(p + 1, d - 1)) for p in range(d)]

