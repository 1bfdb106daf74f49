"""2D DenseUNet-167 (counterpart of hdenseunet_tpu/models/denseunet2d.py).

DenseNet-161 encoder + 5-stage upsampling decoder. One forward serves the
2D training stage (live BN, decoder dropout 0.3 at up4) and the hybrid's 2D
branch (every BN frozen, no decoder dropout). Layer names are the reference
graph's, byte for byte.

Two decoders: the current one (reference densenet.py:10-101), with no long
skip connections, and with ``skip_connections=True`` the legacy one
(reference denseunet.py:130-227): a 1x1 conv 'line0' projects box[3]
(concat_4) and is added at up0, and box[2], box[1], box[0] (concat_3,
concat_2, relu1) are added at up1, up2, up3. The hybrid's 2D branch is the
current one.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L

EPS_ENCODER = 1.1e-5  # reference densenet.py:25
ENC_BLOCKS = (6, 12, 36, 24)  # DenseNet-161 (densenet.py:41)
GROWTH_RATE = 48
INITIAL_FILTERS = 96
DECODER_WIDTHS = (768, 384, 96, 96, 64)

# 'full' is the reference DenseNet-161 layout; 'tiny' a same-wiring test size.
PRESETS = {
    "full": {},
    "tiny": {
        "blocks": (2, 2, 2, 2),
        "growth": 8,
        "decoder_widths": (32, 32, 16, 16, 16),
    },
}


class DenseUNet2D(nn.ModuleDict):
    """The model is the dict of its reference-named layers, plus forward.
    ``skip_connections`` selects the legacy decoder (module docstring); its
    adds need decoder widths 0-2 equal to box[2], box[1] and box[0]'s
    channels, as the full layout's are (768, 384, 96)."""

    def __init__(
        self, *, in_channels=3, num_classes=3, reduction=0.5,
        blocks=ENC_BLOCKS, growth=GROWTH_RATE, decoder_widths=DECODER_WIDTHS,
        skip_connections=False, device=None,
    ):
        super().__init__()
        self.blocks = tuple(blocks)
        self.skip_connections = skip_connections
        compression = 1.0 - reduction

        def conv(name, cin, cout, k, **kw):
            self[name] = L.Conv(cin, cout, k, ndim=2, name=name, device=device, **kw)

        def bn_scale(base, c):
            self[base + "_bn"] = L.BatchNorm(c, eps=EPS_ENCODER, device=device)
            self[base + "_scale"] = L.Scale(c, device=device)

        conv("conv1", in_channels, INITIAL_FILTERS, 7, stride=2, padding=3, use_bias=False)
        bn_scale("conv1", INITIAL_FILTERS)
        nb_filter = INITIAL_FILTERS
        for block_idx, nb_layers in enumerate(self.blocks):
            stage = block_idx + 2
            for branch in range(1, nb_layers + 1):
                base = f"conv{stage}_{branch}"
                bn_scale(base + "_x1", nb_filter)
                conv(base + "_x1", nb_filter, growth * 4, 1, padding="valid", use_bias=False)
                bn_scale(base + "_x2", growth * 4)
                conv(base + "_x2", growth * 4, growth, 3, padding=1, use_bias=False)
                nb_filter += growth
            bn_scale(f"conv{stage}_blk", nb_filter)
            if block_idx < len(self.blocks) - 1:  # transition
                box_channels = nb_filter  # the last is box[3]'s
                out = int(nb_filter * compression)
                conv(f"conv{stage}_blk", nb_filter, out, 1, padding="valid", use_bias=False)
                nb_filter = out
        cin = nb_filter
        if skip_connections:  # box[3]'s projection to the final features' width
            conv("line0", box_channels, nb_filter, 1, padding="same", init="normal")
        for idx, width in enumerate(decoder_widths):
            conv(f"conv_up{idx}", cin, width, 3, padding="same", init="normal")
            self[f"bn_up{idx}"] = L.BatchNorm(width, eps=1e-3, device=device)
            cin = width
        conv("dense167classifer", cin, num_classes, 1, padding="same", init="normal")

    def _bsr(self, x, base, ctx, frozen):
        return L.bn_scale_relu(
            x, self[base + "_bn"], self[base + "_scale"], ctx=ctx, frozen=frozen
        )

    def _conv_block(self, ctx, x, base, frozen, rate):
        """BN-Scale-ReLU-Conv1x1 bottleneck, then BN-Scale-ReLU-Conv3x3
        (densenet.py:103-137)."""
        x = L.maybe_dropout(ctx, self[base + "_x1"](self._bsr(x, base + "_x1", ctx, frozen)), rate)
        return L.maybe_dropout(ctx, self[base + "_x2"](self._bsr(x, base + "_x2", ctx, frozen)), rate)

    def forward(
        self, x, ctx: L.Ctx | None = None, *, bn_frozen: bool = False,
        decoder_dropout: float = 0.3, block_dropout: float = 0.0, taps: dict | None = None,
    ):
        """x: (B, H, W, 3), H and W divisible by 32 ->
        (ac_up4 features (B, H, W, F), logits (B, H, W, num_classes)).

        ``ctx`` None is inference, where each dense block lives in one
        buffer and every bottleneck and transition is one K5 launch
        (:func:`layers.dense_block`). With a training ``ctx`` the BNs use batch
        statistics unless ``bn_frozen``, dropout runs at ``block_dropout``
        after every encoder conv and at ``decoder_dropout`` before bn_up4,
        and each conv block may be rematerialised (denseunet2d.py:46-218).
        ``taps``, when given a dict, records the reference graph's tap layers
        (relu1, concat_{stage}_{n}, relu{S}_blk, ac_up4, dense167classifer,
        and the legacy decoder's line0) for parity audits (weights/parity.py),
        each (B, H, W, C).
        """
        assert x.dim() == 4 and x.shape[1] % 32 == 0 and x.shape[2] % 32 == 0, x.shape
        frozen, rate = bn_frozen, block_dropout
        x = L.channels_last(x.movedim(-1, 1))
        x = self._bsr(self["conv1"](x), "conv1", ctx, frozen)
        L.tap(taps, "relu1", x)
        box = [x]  # the encoder's skip features (denseunet.py:168-177)
        x = L.max_pool(x, 3, 2, pad=1)
        fused = L.fused_1x1(ctx)
        for block_idx, nb_layers in enumerate(self.blocks):
            stage = block_idx + 2
            last = block_idx == len(self.blocks) - 1
            if fused:  # the block in one buffer, each bottleneck one K5 launch
                x = L.dense_block(self, x, f"conv{stage}", nb_layers, lambda conv, h: conv(h))
            else:
                for branch in range(1, nb_layers + 1):  # dense block (densenet.py:103-193)
                    block = lambda c, f, base=f"conv{stage}_{branch}": self._conv_block(
                        c, f, base, frozen, rate
                    )
                    x = L.channels_last(torch.cat([x, L.maybe_remat(ctx, block, x)], dim=1))
            if not last:
                L.tap(taps, f"concat_{stage}_{nb_layers}", x)
                box.append(x)
            if last:
                x = self._bsr(x, f"conv{stage}_blk", ctx, frozen)
                L.tap(taps, f"relu{stage}_blk", x)
            elif fused:  # transition (densenet.py:140-166): BN∘Scale∘ReLU and conv in K5
                x = L.avg_pool(L.bsr_conv1x1(self, x, f"conv{stage}_blk"), 2, 2)
            else:
                x = self._bsr(x, f"conv{stage}_blk", ctx, frozen)
                x = L.maybe_dropout(ctx, self[f"conv{stage}_blk"](x), rate)
                x = L.avg_pool(x, 2, 2)
        skips = [None] * 5
        if self.skip_connections:  # denseunet.py:189-209; up4 has none
            skips[0] = self["line0"](box[3])
            L.tap(taps, "line0", skips[0])
            skips[1], skips[2], skips[3] = box[2], box[1], box[0]
        for idx in range(5):  # UpSample2x -> [+skip] -> Conv3x3 -> [Dropout] -> BN -> ReLU
            x = L.upsample_nearest(x, 2)
            if skips[idx] is not None:
                x = skips[idx] + x
            x = self[f"conv_up{idx}"](x)
            if idx == 4:
                x = L.maybe_dropout(ctx, x, decoder_dropout)
            x = L.bn_relu(x, self[f"bn_up{idx}"], ctx, frozen=frozen)
        logits = self["dense167classifer"](x)
        L.tap(taps, "ac_up4", x)
        L.tap(taps, "dense167classifer", logits)
        return x.movedim(1, -1), logits.movedim(1, -1)
