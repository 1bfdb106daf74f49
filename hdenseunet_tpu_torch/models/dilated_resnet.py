"""3D dilated residual encoder-decoder (counterpart of
hdenseunet_tpu/models/dilated_resnet.py; reference hybridnet.py:426-585
``dilated_resnet``).

A defined-but-unused alternative architecture of the reference, kept for
capability parity. The reference leaves its layers auto-named and released
no checkpoint, so the layer names are the JAX package's deterministic
``dr_*`` ones, and its parameters cross the bridge (core/params.py) as the
other models' do. Every conv is 'same' with a bias and ``init="normal"``;
its padding is given explicitly, ``(k - 1) * dilation // 2`` a side, as the
JAX module pads. BatchNorms are Keras's (eps 1e-3), live under a training
``ctx`` and on their moving statistics otherwise; no Pallas kernel serves
this network in the JAX package, so its BN and ReLU stay PyTorch ops.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L

WIDTHS = (64, 128, 256, 512)  # reference hybridnet.py:428-470
POOL = (2, 2, 1)  # every pool and upsample keeps z


class DilatedResNet(nn.ModuleDict):
    """The model is the dict of its ``dr_*`` layers, plus forward."""

    def __init__(self, *, in_channels=1, num_classes=2, widths=WIDTHS, device=None):
        super().__init__()
        w0, w1, w2, w3 = widths

        def conv(name, cin, cout, k, dilation=1):
            self[name] = L.Conv(
                cin, cout, k, ndim=3, padding=(k - 1) * dilation // 2, dilation=dilation,
                init="normal", name=name, device=device,
            )

        def conv_bn(name, bn, cin, cout, k, dilation=1):
            conv(name, cin, cout, k, dilation)
            self[bn] = L.BatchNorm(cout, device=device)

        def res_block(name, cin, ch):
            conv_bn(f"{name}_c1", f"{name}_bn1", cin, ch, 3)
            conv_bn(f"{name}_c2", f"{name}_bn2", ch, ch, 3)
            conv_bn(f"{name}_proj", f"{name}_bnp", cin, ch, 1)

        def dilated_block(name, ch):
            conv_bn(f"{name}_c1", f"{name}_bn1", ch, ch, 3, dilation=2)
            conv_bn(f"{name}_c2", f"{name}_bn2", ch, ch, 3, dilation=2)

        conv_bn("dr_stem", "dr_stem_bn", in_channels, w0, 3)
        res_block("dr_res1", w0, w1)
        res_block("dr_res2", w1, w2)
        res_block("dr_res3", w2, w3)
        dilated_block("dr_dil1", w3)
        res_block("dr_res4", w3, w3)
        dilated_block("dr_dil2", w3)
        conv_bn("dr_up0_proj", "dr_up0_bn", w3, w3, 1)  # skip: dr_dil1's output
        res_block("dr_res5", w3, w3)
        dilated_block("dr_dil3", w3)
        conv_bn("dr_up1_proj", "dr_up1_bn", w2, w3, 1)  # skip: dr_res2's
        res_block("dr_res6", w3, w2)
        conv_bn("dr_up2_proj", "dr_up2_bn", w1, w2, 1)  # skip: dr_res1's
        res_block("dr_res7", w2, w1)
        conv_bn("dr_up3_proj", "dr_up3_bn", w0, w1, 1)  # skip: the stem's
        res_block("dr_res8", w1, w0)
        conv("dr_head", w0, num_classes, 1)

    def _conv_bn(self, x, name, bn, ctx):
        return self[bn](self[name](x), ctx)

    def _res_block(self, x, name, ctx):
        """conv-bn-relu-conv-bn plus a 1x1 conv-bn shortcut, add, relu
        (hybridnet.py:434-442)."""
        y = torch.relu(self._conv_bn(x, f"{name}_c1", f"{name}_bn1", ctx))
        y = self._conv_bn(y, f"{name}_c2", f"{name}_bn2", ctx)
        s = self._conv_bn(x, f"{name}_proj", f"{name}_bnp", ctx)
        return torch.relu(s + y)

    def _dilated_block(self, x, name, ctx):
        """Two dilation-2 convs with an identity residual (hybridnet.py:472-478)."""
        y = torch.relu(self._conv_bn(x, f"{name}_c1", f"{name}_bn1", ctx))
        y = self._conv_bn(y, f"{name}_c2", f"{name}_bn2", ctx)
        return torch.relu(x + y)

    def _up_merge(self, x_up, x_skip, name, ctx):
        """A (2,2,1) upsample plus a BN'd 1x1 projection of the skip, no relu
        (hybridnet.py:503-506)."""
        up = L.upsample_nearest(x_up, POOL)
        return self._conv_bn(x_skip, f"{name}_proj", f"{name}_bn", ctx) + up

    def forward(self, x, ctx: L.Ctx | None = None, *, taps: dict | None = None):
        """x: (B, H, W, D, C), H and W divisible by 16 -> logits (B, H, W, D,
        num_classes). ``ctx`` None is inference; a training ``ctx`` gives
        live BNs, whose new moving statistics land in ``ctx.new_stats``.
        ``taps``, when given a dict, records the logits as 'dr_head'
        (weights/parity.py)."""
        assert x.dim() == 5 and x.shape[1] % 16 == 0 and x.shape[2] % 16 == 0, x.shape
        x = L.channels_last(x.movedim(-1, 1))
        ac0 = torch.relu(self._conv_bn(x, "dr_stem", "dr_stem_bn", ctx))
        res1 = self._res_block(L.max_pool(ac0, POOL, POOL), "dr_res1", ctx)
        res2 = self._res_block(L.max_pool(res1, POOL, POOL), "dr_res2", ctx)
        res3 = self._res_block(L.max_pool(res2, POOL, POOL), "dr_res3", ctx)
        delres = self._dilated_block(res3, "dr_dil1", ctx)
        res3_4 = self._res_block(L.max_pool(delres, POOL, POOL), "dr_res4", ctx)
        delres2 = self._dilated_block(res3_4, "dr_dil2", ctx)
        res4_1 = self._res_block(self._up_merge(delres2, delres, "dr_up0", ctx), "dr_res5", ctx)
        delres3 = self._dilated_block(res4_1, "dr_dil3", ctx)
        res4 = self._res_block(self._up_merge(delres3, res2, "dr_up1", ctx), "dr_res6", ctx)
        res5 = self._res_block(self._up_merge(res4, res1, "dr_up2", ctx), "dr_res7", ctx)
        res6 = self._res_block(self._up_merge(res5, ac0, "dr_up3", ctx), "dr_res8", ctx)
        logits = self["dr_head"](res6)
        L.tap(taps, "dr_head", logits)
        return logits.movedim(1, -1)
