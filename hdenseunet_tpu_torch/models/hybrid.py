"""H-DenseUNet: hybrid 2D/3D assembly with HFF (hybrid feature fusion).

Counterpart of hdenseunet_tpu/models/hybrid.py. Each z slice's 3-slice stack
goes through the 2D DenseUNet; its logits, amplified x250, join the raw
volume as the 4-channel input of the 3D DenseUNet; the 3D feature map plus
the z-stacked 2D features go through the HFF head (hybridnet.py:379-423).
Both hybrid archs freeze every 2D BN and train the 3D branch's and the
head's with live statistics; the archs differ in the head's dropout rate
(0.3 end2end, 0.1 3dpart; the identity at inference) and in which leaves
train (:func:`trainable_predicate`, applied by train/optimizer.py).

A training forward (``ctx`` given) records the program's spans
(``utils/profiling.py``): ``branch2d`` (the slice stacks, the 2D branch and
the unstack), ``branch3d`` (the x250 fusion and the 3D DenseUNet) and
``hff`` (the head). An inference forward records none.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..utils.profiling import annotate
from . import denseunet2d, denseunet3d
from . import layers as L

LOGIT_AMPLIFICATION = 250.0  # reference hybridnet.py:409
HEAD_WIDTH = 64


def _span(ctx: L.Ctx | None, name: str):
    """The program's span ``name`` in a training forward; none at inference."""
    return contextlib.nullcontext() if ctx is None else annotate(name)


def stack_adjacent_slices(vol):
    """(B, H, W, D, 1) volume -> (B*D, H, W, 3) pseudo-batch of 3-slice stacks
    [z-1, z, z+1] with edge replication, z-major per batch element."""
    b, h, w, d = vol.shape[:4]
    x = vol[..., 0]
    idx = torch.arange(d, device=vol.device)
    prev = x[..., (idx - 1).clamp(min=0)]
    nxt = x[..., (idx + 1).clamp(max=d - 1)]
    stacks = torch.stack([prev, x, nxt], dim=-1)  # (B,H,W,D,3)
    return stacks.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, 3)


def unstack_to_volume(y, batch, depth):
    """(B*D, H, W, C) -> (B, H, W, D, C), inverse of the pseudo-batch fold."""
    bd, h, w, c = y.shape
    assert bd == batch * depth, (y.shape, batch, depth)
    return y.reshape(batch, depth, h, w, c).permute(0, 2, 3, 1, 4)


class HFFHead(nn.ModuleDict):
    """add -> Conv3D(64) -> Dropout -> BN -> ReLU -> 1x1x1 Conv '2d3dclassifer'
    (hybridnet.py:414-419), in the 3D branch's form (hybrid.py:120-163)."""

    def __init__(self, width, *, num_classes=3, device=None):
        super().__init__()
        self["fianl_conv"] = L.Conv(width, HEAD_WIDTH, 3, ndim=3, name="fianl_conv", device=device)  # [sic]
        self["final_bn"] = L.BatchNorm(HEAD_WIDTH, eps=1e-3, device=device)
        self["2d3dclassifer"] = L.Conv(
            HEAD_WIDTH, num_classes, 1, ndim=3, name="2d3dclassifer", device=device
        )

    def forward(
        self, feat3d, fea2d, ctx: L.Ctx | None = None, *, arch: str = "end2end",
        layout: str = "hwdc", fold_z: bool = False,
    ):
        """feat3d, fea2d: (B, H, W, D, F) -> logits (B, H, W, D, num_classes).

        ``layout='dhwc'`` runs the head d-major: ``feat3d`` is then already
        (B, D, H, W, F) (the 3D branch with ``unfold_outputs=False``) and
        ``fea2d`` stays canonical. ``fold_z`` runs it z-folded."""
        ops = denseunet3d.ops_for(layout, fold_z)
        if layout == "dhwc":  # HFF (hybridnet.py:414)
            fused = L.channels_last((feat3d + fea2d.permute(0, 3, 1, 2, 4)).movedim(-1, 1))
        else:
            fused = ops.fold((feat3d + fea2d).movedim(-1, 1))
        f = ops.conv(self["fianl_conv"], fused)
        f = L.maybe_dropout(ctx, f, 0.3 if arch == "end2end" else 0.1)
        f = L.bn_relu(f, self["final_bn"], ctx)
        return ops.unfold(ops.conv(self["2d3dclassifer"], f)).movedim(1, -1)


class HDenseUNet(nn.Module):
    """The hybrid network; ``forward`` is the counterpart of ``hybrid.apply``."""

    def __init__(self, *, preset: str = "full", num_classes: int = 3, device=None):
        super().__init__()
        self.preset = preset
        kw2d = dict(denseunet2d.PRESETS[preset])
        kw3d = dict(denseunet3d.PRESETS[preset])
        self.net2d = denseunet2d.DenseUNet2D(num_classes=num_classes, device=device, **kw2d)
        self.net3d = denseunet3d.DenseUNet3D(
            in_channels=1 + num_classes, num_classes=num_classes, device=device, **kw3d
        )
        width2d = kw2d.get("decoder_widths", denseunet2d.DECODER_WIDTHS)[-1]
        width3d = kw3d.get("decoder_widths", denseunet3d.DECODER_WIDTHS)[-1]
        assert width2d == width3d, (width2d, width3d)
        self.head = HFFHead(width3d, num_classes=num_classes, device=device)

    def forward(
        self, vol, ctx: L.Ctx | None = None, *, arch: str = "end2end", taps: dict | None = None,
        layout3d: str = "hwdc", stem_s2d: bool = False, fold_z: bool = False,
    ):
        """vol: (B, H, W, D, 1); H, W divisible by 32; D by 4 ->
        logits (B, H, W, D, num_classes). ``ctx``: None for inference, a
        training :class:`layers.Ctx` otherwise (hybrid.py:68-118). ``taps``,
        when given a dict, records the fusion boundary: res2d, fea2d, feat3d
        and 2d3dclassifer, each (B, H, W, D, C) (weights/parity.py).
        ``layout3d`` 'hwdc' | 'dhwc', ``stem_s2d`` and ``fold_z`` select the
        form of the 3D branch and the head (models/denseunet3d.py)."""
        assert arch in ("end2end", "3dpart"), arch
        b, _, _, d = vol.shape[:4]
        with _span(ctx, "branch2d"):
            feat2d, logits2d = self.net2d(
                stack_adjacent_slices(vol), ctx, bn_frozen=True, decoder_dropout=0.0
            )
            res2d, fea2d = unstack_to_volume(logits2d, b, d), unstack_to_volume(feat2d, b, d)
        if taps is not None:
            taps.update(res2d=res2d, fea2d=fea2d)
        return self.fuse(
            vol, res2d, fea2d, ctx, arch=arch, taps=taps, layout3d=layout3d, stem_s2d=stem_s2d,
            fold_z=fold_z,
        )

    def fuse(
        self, vol, res2d, fea2d, ctx: L.Ctx | None = None, *, arch: str = "end2end",
        taps: dict | None = None, layout3d: str = "hwdc", stem_s2d: bool = False,
        fold_z: bool = False,
    ):
        """The hybrid after its 2D branch: x250 fusion -> 3D DenseUNet -> HFF.

        vol (B,H,W,D,1), res2d (B,H,W,D,C) 2D logits, fea2d (B,H,W,D,F) 2D
        features -> logits (B,H,W,D,C); ``taps`` gets feat3d and the logits.
        Under 'dhwc' the 3D branch hands its features to the head d-major."""
        dhwc = layout3d == "dhwc"
        with _span(ctx, "branch3d"):
            input3d = torch.cat([vol, res2d * LOGIT_AMPLIFICATION], dim=-1)
            feat3d, _ = self.net3d(
                input3d, ctx, layout=layout3d, stem_s2d=stem_s2d, fold_z=fold_z,
                unfold_outputs=not dhwc,
            )
        with _span(ctx, "hff"):
            logits = self.head(feat3d, fea2d, ctx, arch=arch, layout=layout3d, fold_z=fold_z)
        if taps is not None:
            if dhwc:
                feat3d = feat3d.permute(0, 2, 3, 1, 4)
            taps.update({"feat3d": feat3d, "2d3dclassifer": logits})
        return logits


def is_2d_name(name: str) -> bool:
    """Layer names belonging to the 2D branch of the hybrid graph."""
    if name.startswith("3d"):
        return False
    return not name in ("fianl_conv", "final_bn", "2d3dclassifer")


def trainable_predicate(arch: str):
    """Return f(layer_name, leaf_name) -> bool for the given training stage.

    * '2d'      — everything trains (train_2ddense.py stage);
    * '3dpart'  — only the 3D branch + HFF head train (denseunet3d.py:222-224:
                  the whole 2D branch is `trainable=False`);
    * 'end2end' — 2D BN gamma/beta frozen, everything else trains
                  (hybridnet.py:210-212: convs/Scales `trainable=True`, BNs
                  `trainable=False`).
    """
    if arch == "2d":
        return lambda name, leaf: True
    if arch == "3dpart":
        return lambda name, leaf: not is_2d_name(name)
    if arch == "end2end":
        def pred(name, leaf):
            if not is_2d_name(name):
                return True
            return not (name.endswith("_bn") or name.startswith("bn_up"))
        return pred
    raise ValueError(f"unknown arch {arch!r}")
