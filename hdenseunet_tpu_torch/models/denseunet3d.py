"""3D DenseUNet branch (counterpart of hdenseunet_tpu/models/denseunet3d.py).

3D DenseNet encoder (growth 32, blocks (3,4,12,8)) with a 7x7x7 stride-2
stem, z-preserving (2,2,1) transitions, and a decoder of three (2,2,1) and
two (2,2,2) nearest upsamples.

The branch runs in one of the JAX package's execution forms, each the same
multiply-accumulate set on the same parameters (outputs differ by float
summation order only), chosen by ``forward``'s keywords:
* 'hwdc', the canonical layout: spatial dims in the JAX order (H, W, D);
* 'dhwc', the d-major layout (models/dmajor.py): spatial dims (D, H, W);
* ``fold_z``: every op a 2D op on (B·D, C, H, W) (models/zfold.py);
* ``stem_s2d``: the stem as a space-to-depth stride-1 conv (models/s2d.py),
  in either layout.
The op sets below carry each form's convolutions, pools and upsamples; the
blocks call them and nothing else of the layout.
"""
from __future__ import annotations

import torch
from torch import nn

from . import dmajor, s2d, zfold
from . import layers as L

EPS_ENCODER = 1.1e-5  # reference denseunet3d.py:28
ENC_BLOCKS = (3, 4, 12, 8)  # reference denseunet3d.py:126
GROWTH_RATE = 32
INITIAL_FILTERS = 96
DECODER_WIDTHS = (504, 224, 192, 96, 64)
UPSAMPLE = ((2, 2, 1), (2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2))

PRESETS = {
    "full": {},
    "tiny": {
        "blocks": (1, 1, 2, 2),
        "growth": 8,
        "decoder_widths": (16, 16, 16, 16, 16),
    },
}


class _DirectOps:
    """Canonical (B, C, H, W, D) tensors through layers.Conv et al."""

    def fold(self, x):
        return L.channels_last(x)

    def conv(self, conv, x):
        return conv(x)

    def stem_s2d(self, conv, x):
        return s2d.conv3d_s2d(conv, x)

    def max_pool(self, x, window, stride, pad=0):
        return L.max_pool(x, window, stride, pad=pad)

    def avg_pool(self, x, window, stride):
        return L.avg_pool(x, window, stride)

    def upsample(self, x, factors):
        return L.upsample_nearest(x, factors)

    def unfold(self, x):
        return x


class _DMajorOps:
    """D-major (B, C, D, H, W) tensors (models/dmajor.py)."""

    def fold(self, x):
        return dmajor.fold(x)

    def conv(self, conv, x):
        return dmajor.conv3d(conv, x)

    def stem_s2d(self, conv, x):
        return s2d.conv3d_s2d(conv, x, kernel_perm=dmajor.PERM)

    def max_pool(self, x, window, stride, pad=0):
        return dmajor.max_pool(x, window, stride, pad=pad)

    def avg_pool(self, x, window, stride):
        return dmajor.avg_pool(x, window, stride)

    def upsample(self, x, factors):
        return dmajor.upsample_nearest(x, factors)

    def unfold(self, x):
        return dmajor.unfold(x)


class _FoldedOps:
    """z-folded (B·D, C, H, W) tensors (models/zfold.py); tracks the depth
    that z-strided ops consume and produce."""

    def fold(self, x):
        x, self.b, self.d = zfold.fold(x)
        return x

    def conv(self, conv, x):
        y, self.d = zfold.conv3d(conv, x, self.b, self.d)
        return y

    def max_pool(self, x, window, stride, pad=0):
        y, self.d = zfold.max_pool(x, self.b, self.d, window, stride, pad=pad)
        return y

    def avg_pool(self, x, window, stride):
        y, self.d = zfold.avg_pool(x, self.b, self.d, window, stride)
        return y

    def upsample(self, x, factors):
        y, self.d = zfold.upsample_nearest(x, self.b, self.d, factors)
        return y

    def unfold(self, x):
        return zfold.unfold(x, self.b, self.d)


def ops_for(layout: str = "hwdc", fold_z: bool = False):
    """The op set of a form, with the JAX package's exclusions."""
    assert layout in ("hwdc", "dhwc"), layout
    assert not (fold_z and layout != "hwdc"), "fold_z and dhwc are exclusive"
    if fold_z:
        return _FoldedOps()
    return _DMajorOps() if layout == "dhwc" else _DirectOps()


class DenseUNet3D(nn.ModuleDict):
    """The model is the dict of its reference-named layers, plus forward."""

    def __init__(
        self, *, in_channels=4, num_classes=3, reduction=0.5,
        blocks=ENC_BLOCKS, growth=GROWTH_RATE, decoder_widths=DECODER_WIDTHS,
        device=None,
    ):
        super().__init__()
        self.blocks = tuple(blocks)
        compression = 1.0 - reduction

        def conv(name, cin, cout, k, **kw):
            self[name] = L.Conv(cin, cout, k, ndim=3, name=name, device=device, **kw)

        def bn_scale(base, c):
            self[base + "_bn"] = L.BatchNorm(c, eps=EPS_ENCODER, device=device)
            self[base + "_scale"] = L.Scale(c, device=device)

        conv("3dconv1", in_channels, INITIAL_FILTERS, 7, stride=2, padding=3, use_bias=False)
        bn_scale("3dconv1", INITIAL_FILTERS)
        nb_filter = INITIAL_FILTERS
        for block_idx, nb_layers in enumerate(self.blocks):
            stage = block_idx + 2
            for branch in range(1, nb_layers + 1):
                base = f"3dconv{stage}_{branch}"
                bn_scale(base + "_x1", nb_filter)
                conv(base + "_x1", nb_filter, growth * 4, 1, padding="valid", use_bias=False)
                bn_scale(base + "_x2", growth * 4)
                conv(base + "_x2", growth * 4, growth, 3, padding=1, use_bias=False)
                nb_filter += growth
            bn_scale(f"3dconv{stage}_blk", nb_filter)
            if block_idx < len(self.blocks) - 1:  # transition
                out = int(nb_filter * compression)
                conv(f"3dconv{stage}_blk", nb_filter, out, 1, padding="valid", use_bias=False)
                nb_filter = out
        cin = nb_filter
        for idx, width in enumerate(decoder_widths):
            conv(f"3dconv_up{idx}", cin, width, 3, padding="same")
            self[f"3dbn_up{idx}"] = L.BatchNorm(width, eps=1e-3, device=device)
            cin = width
        conv("3dclassifer", cin, num_classes, 1, padding="same")

    def _bsr(self, x, base, ctx, frozen):
        return L.bn_scale_relu(
            x, self[base + "_bn"], self[base + "_scale"], ctx=ctx, frozen=frozen
        )

    def _conv_block(self, ops, ctx, x, base, frozen, rate):
        """Reference denseunet3d.py:18-52."""
        x = self._bsr(x, base + "_x1", ctx, frozen)
        x = L.maybe_dropout(ctx, ops.conv(self[base + "_x1"], x), rate)
        x = self._bsr(x, base + "_x2", ctx, frozen)
        return L.maybe_dropout(ctx, ops.conv(self[base + "_x2"], x), rate)

    def forward(
        self, x, ctx: L.Ctx | None = None, *, bn_frozen: bool = False,
        block_dropout: float = 0.0, taps: dict | None = None, layout: str = "hwdc",
        fold_z: bool = False, stem_s2d: bool = False, unfold_outputs: bool = True,
    ):
        """x: (B, H, W, D, C), H and W divisible by 32, D by 4 ->
        (ac_up4 features (B, H, W, D, F), logits (B, H, W, D, num_classes)).

        ``ctx`` None is inference, each dense block in one buffer and every
        bottleneck and transition one K5 launch, a 1x1x1 convolution being
        the same product of rows in every form (:func:`layers.dense_block`);
        a training ``ctx`` gives live BNs (unless
        ``bn_frozen``), dropout at ``block_dropout`` after every encoder conv
        and per-block remat (denseunet3d.py:126-294). Dropout keeps elements
        by their index in the form's memory order, so each form draws
        another mask of the same distribution. ``taps``, when given a dict,
        records 3dconcat_{stage}_{n}, 3drelu{S}_blk, 3dac_up4 and 3dclassifer
        (weights/parity.py), each (B, H, W, D, C) in every form.

        ``layout`` 'hwdc' | 'dhwc', ``fold_z`` and ``stem_s2d`` select the
        form (module docstring); fold_z excludes 'dhwc' and ``stem_s2d``.
        ``unfold_outputs=False`` ('dhwc' only) returns both outputs d-major,
        (B, D, H, W, C), for a d-major consumer (the hybrid's HFF head)."""
        assert x.dim() == 5 and x.shape[1] % 32 == 0 and x.shape[2] % 32 == 0, x.shape
        assert x.shape[3] % 4 == 0, f"depth {x.shape[3]} must be divisible by 4"
        assert unfold_outputs or layout == "dhwc", "unfold_outputs=False needs dhwc"
        assert not (stem_s2d and fold_z), "stem_s2d and fold_z are exclusive"
        ops = ops_for(layout, fold_z)
        frozen, rate = bn_frozen, block_dropout

        def tap(name, t):
            if taps is not None:
                L.tap(taps, name, ops.unfold(t))

        x = ops.fold(x.movedim(-1, 1))
        stem = self["3dconv1"]
        x = ops.stem_s2d(stem, x) if stem_s2d else ops.conv(stem, x)
        x = ops.max_pool(self._bsr(x, "3dconv1", ctx, frozen), 3, 2, pad=1)
        fused = L.fused_1x1(ctx)
        for block_idx, nb_layers in enumerate(self.blocks):
            stage = block_idx + 2
            last = block_idx == len(self.blocks) - 1
            if fused:  # the block in one buffer, each bottleneck one K5 launch
                x = L.dense_block(self, x, f"3dconv{stage}", nb_layers, ops.conv)
            else:
                for branch in range(1, nb_layers + 1):  # dense block (denseunet3d.py:18-77)
                    block = lambda c, f, base=f"3dconv{stage}_{branch}": self._conv_block(
                        ops, c, f, base, frozen, rate
                    )
                    x = L.channels_last(torch.cat([x, L.maybe_remat(ctx, block, x)], dim=1))
            if not last:
                tap(f"3dconcat_{stage}_{nb_layers}", x)
            if last:
                x = self._bsr(x, f"3dconv{stage}_blk", ctx, frozen)
                tap(f"3drelu{stage}_blk", x)
            elif fused:  # z-preserving transition, its BN∘Scale∘ReLU and conv in K5
                x = ops.avg_pool(L.bsr_conv1x1(self, x, f"3dconv{stage}_blk"), (2, 2, 1), (2, 2, 1))
            else:
                x = self._bsr(x, f"3dconv{stage}_blk", ctx, frozen)
                x = L.maybe_dropout(ctx, ops.conv(self[f"3dconv{stage}_blk"], x), rate)
                x = ops.avg_pool(x, (2, 2, 1), (2, 2, 1))
        for idx, up in enumerate(UPSAMPLE):  # UpSample -> Conv3x3x3 -> BN -> ReLU
            x = ops.conv(self[f"3dconv_up{idx}"], ops.upsample(x, up))
            x = L.bn_relu(x, self[f"3dbn_up{idx}"], ctx, frozen=frozen)
        logits = ops.conv(self["3dclassifer"], x)
        tap("3dac_up4", x)
        tap("3dclassifer", logits)
        if unfold_outputs:
            x, logits = ops.unfold(x), ops.unfold(logits)
        return x.movedim(1, -1), logits.movedim(1, -1)
