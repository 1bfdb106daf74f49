"""Work counts from the frozen reference's shapes, and the card's peaks.

The counts run the reference networks (``reference/models.py``) on the
meta device, where a convolution computes its output's shape and nothing
else, and add 2 x outputs x out channels x kernel taps x in channels per
convolution. They follow the configuration's widths and the reference's
semantics, never the program's batching, so a change to the program moves
none of them.

* :func:`serve_volume`: the convolution FLOPs of the distinct work one
  volume needs (each distinct 2D slice stack once, each distinct window's
  3D branch and head once; the 3D branch's own classifier feeds nothing and
  is not counted), and the K5 bound: for each of the encoders' 1x1
  convolutions (bottlenecks and transitions), the rows of every distinct
  stack or window at that layer as one product, max((MK + NK + MN) x 2 B /
  bandwidth, 2MNK / peak), summed.
* :func:`train_step`: 3 x the 2D network's forward FLOPs at the batch
  (forward, and a backward of twice the forward); recomputation is not
  counted.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..reference import models as R
from ..reference import serve as S

# NVIDIA's data sheet, H100 SXM5 (80GB HBM3), dense bfloat16 and HBM3 rates
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The card's published peaks, or None for a card not in the table."""
    return PEAKS.get(kind)


class CountOps:
    """Meta-device convolutions that add up their FLOPs and record each
    one's (name, rows M, K, N) where the kernel is 1x1(x1)."""

    def __init__(self):
        self.flops = 0.0
        self.gemms: list = []

    def conv(self, x, w, b, stride, pad, name=None):
        fn = F.conv2d if x.dim() == 4 else F.conv3d
        y = fn(x, w, b, stride, pad)
        taps = math.prod(w.shape[2:])
        outputs = y.shape[0] * math.prod(y.shape[2:])
        self.flops += 2.0 * outputs * w.shape[0] * taps * w.shape[1]
        if taps == 1 and name is not None and (name.endswith("_x1") or name.endswith("_blk")):
            self.gemms.append((name, outputs, int(w.shape[1]), int(w.shape[0])))
        return y

    def act(self, x):
        return x


def _meta_params(cfg) -> dict:
    return {k: torch.empty(shape, device="meta") for k, shape, _ in R.layer_table(cfg)}


def forward_2d(cfg, batch: int, size: int, prefix: str = "") -> CountOps:
    ops = CountOps()
    x = torch.empty((batch, cfg["net2d"]["in_channels"], size, size), device="meta")
    R.forward_2d(ops, x, _meta_params(cfg), cfg, prefix=prefix)
    return ops


def window_3d(cfg, x: int, y: int) -> CountOps:
    """The 3D branch and head of one window."""
    ops = CountOps()
    d, nc, fw = cfg["infer"]["input_cols"], cfg["num_classes"], cfg["net2d"]["decoder_widths"][-1]
    vol = torch.empty((1, 1, x, y, d), device="meta")
    R.fuse(ops, vol, torch.empty((1, nc, x, y, d), device="meta"),
           torch.empty((1, fw, x, y, d), device="meta"), _meta_params(cfg), cfg)
    return ops


def _bound(gemms, copies: int, pk: dict) -> float:
    total = 0.0
    for _, m, k, n in gemms:
        m *= copies
        total += max((m * k + n * k + m * n) * 2.0 / pk["hbm_bytes_per_s"],
                     2.0 * m * n * k / pk["bf16_flops"])
    return total


def serve_volume(cfg, shape, ext_mask_z: tuple, pk: dict | None) -> dict:
    """{flops, k5_bound_s (None without peaks), stacks, windows} of one
    volume of ``shape`` whose dilated external mask spans slices
    ``ext_mask_z`` (lowest, highest)."""
    x, y, z = shape
    mult, stacks = S.distinct_work(z, ext_mask_z[0], ext_mask_z[1], cfg["infer"])
    f2d = forward_2d(cfg, 1, x, prefix="net2d.") if x == y else None
    if f2d is None:
        raise ValueError("square slices only")
    f3d = window_3d(cfg, x, y)
    out = {
        "flops": len(stacks) * f2d.flops + len(mult) * f3d.flops,
        "stacks": len(stacks),
        "windows": len(mult),
        "k5_bound_s": None,
    }
    if pk is not None:
        out["k5_bound_s"] = _bound(f2d.gemms, len(stacks), pk) + _bound(f3d.gemms, len(mult), pk)
    return out


def train_step(cfg, batch: int, size: int) -> float:
    """3 x the 2D network's forward FLOPs at ``batch`` crops of ``size``."""
    return 3.0 * forward_2d(cfg, batch, size).flops
