"""3D DenseUNet branch (counterpart of hdenseunet_tpu/models/denseunet3d.py).

3D DenseNet encoder (growth 32, blocks (3,4,12,8)) with the direct 7x7x7
stride-2 stem, z-preserving (2,2,1) transitions, and a decoder of three
(2,2,1) and two (2,2,2) nearest upsamples. Layout 'hwdc' only: spatial dims
in the JAX order (H, W, D).

The JAX package's ``stem_s2d`` (models/s2d.py) runs the same stem as a
space-to-depth conv, a lever for the TPU's matrix unit that equals the direct
stem up to float-summation order (PARITY.md); here the stem is always direct.
The z-folded and d-major execution forms (zfold.py, dmajor.py) are TPU layout
levers and are not ported.
"""
from __future__ import annotations

import torch
from torch import nn

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

    def _conv_block(self, ctx, x, base, frozen, rate):
        """Reference denseunet3d.py:18-52."""
        x = L.maybe_dropout(ctx, self[base + "_x1"](self._bsr(x, base + "_x1", ctx, frozen)), rate)
        return L.maybe_dropout(ctx, self[base + "_x2"](self._bsr(x, base + "_x2", ctx, frozen)), rate)

    def forward(
        self, x, ctx: L.Ctx | None = None, *, bn_frozen: bool = False,
        block_dropout: float = 0.0, taps: dict | None = None,
    ):
        """x: (B, H, W, D, C), H and W divisible by 32, D by 4 ->
        (ac_up4 features (B, H, W, D, F), logits (B, H, W, D, num_classes)).

        ``ctx`` None is inference; a training ``ctx`` gives live BNs (unless
        ``bn_frozen``), dropout at ``block_dropout`` after every encoder conv
        and per-block remat (denseunet3d.py:126-294). ``taps``, when given a
        dict, records 3dconcat_{stage}_{n}, 3drelu{S}_blk, 3dac_up4 and
        3dclassifer (weights/parity.py), each (B, H, W, D, C)."""
        assert x.dim() == 5 and x.shape[1] % 32 == 0 and x.shape[2] % 32 == 0, x.shape
        assert x.shape[3] % 4 == 0, f"depth {x.shape[3]} must be divisible by 4"
        frozen, rate = bn_frozen, block_dropout
        x = L.channels_last(x.movedim(-1, 1))
        x = self._bsr(self["3dconv1"](x), "3dconv1", ctx, frozen)
        x = L.max_pool(x, 3, 2, pad=1)
        for block_idx, nb_layers in enumerate(self.blocks):
            stage = block_idx + 2
            last = block_idx == len(self.blocks) - 1
            for branch in range(1, nb_layers + 1):  # dense block (denseunet3d.py:18-77)
                block = lambda c, f, base=f"3dconv{stage}_{branch}": self._conv_block(
                    c, f, base, frozen, rate
                )
                x = L.channels_last(torch.cat([x, L.maybe_remat(ctx, block, x)], dim=1))
            if not last:
                L.tap(taps, f"3dconcat_{stage}_{nb_layers}", x)
            x = self._bsr(x, f"3dconv{stage}_blk", ctx, frozen)
            if last:
                L.tap(taps, f"3drelu{stage}_blk", x)
            else:  # z-preserving transition
                x = L.maybe_dropout(ctx, self[f"3dconv{stage}_blk"](x), rate)
                x = L.avg_pool(x, (2, 2, 1), (2, 2, 1))
        for idx, up in enumerate(UPSAMPLE):  # UpSample -> Conv3x3x3 -> BN -> ReLU
            x = self[f"3dconv_up{idx}"](L.upsample_nearest(x, up))
            x = torch.relu(self[f"3dbn_up{idx}"](x, ctx, frozen=frozen))
        logits = self["3dclassifer"](x)
        L.tap(taps, "3dac_up4", x)
        L.tap(taps, "3dclassifer", logits)
        return x.movedim(1, -1), logits.movedim(1, -1)
