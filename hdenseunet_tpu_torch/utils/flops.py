"""Analytic FLOP accounting (counterpart of hdenseunet_tpu/utils/flops.py).

Convolutions are more than 99.9 % of this workload's arithmetic. Counts come
from running the REAL modules on the meta device with the conv hook of
``models.layers.count_flops`` open: the meta device carries shapes and
computes nothing, as ``jax.eval_shape`` does, so the count follows the
actual graph with no hand-kept architecture table. MFU is model FLOP/s over
:func:`peak_flops_per_chip`.
"""
from __future__ import annotations

import os

import torch

# NVIDIA's dense (no sparsity) bf16 Tensor Core peaks, TFLOP/s, by a
# substring of torch.cuda.get_device_name(), most specific first
PEAK_BF16_TFLOPS = {
    "h100 80gb hbm3": 989.4,  # H100 SXM5, 700 W
    "h100 sxm": 989.4,
    "h100 pcie": 756.0,  # H100 PCIe, 350 W
}


def peak_flops_per_chip(kind: str | None = None) -> float:
    """bf16 peak FLOP/s of the card named ``kind`` (default: card 0's
    ``torch.cuda.get_device_name``). ``BENCH_PEAK_TFLOPS`` in the
    environment overrides the table; a card the table does not know raises."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    kind = torch.cuda.get_device_name(0) if kind is None else kind
    for key, tf in PEAK_BF16_TFLOPS.items():
        if key in kind.lower():
            return tf * 1e12
    raise ValueError(
        f"no bf16 peak known for {kind!r}; set BENCH_PEAK_TFLOPS (TFLOP/s) to its data sheet's"
    )


def conv_flops(fn, *example_shapes, **kwargs) -> float:
    """Total conv FLOPs of one ``fn(*args, **kwargs)``, ``fn`` a module built
    on the meta device (or a function of such modules).

    ``example_shapes``: shape tuples (float32 meta tensors are made for
    them) or meta tensors.
    """
    from ..models.layers import count_flops

    args = [
        torch.empty(s, dtype=torch.float32, device="meta") if isinstance(s, tuple) else s
        for s in example_shapes
    ]
    with torch.no_grad(), count_flops() as counter:
        fn(*args, **kwargs)
    return counter.total


def hybrid_window_batch_flops(
    *,
    x: int,
    y: int,
    cols: int,
    wb: int,
    n_stacks_2d: int,
    preset: str = "full",
    num_classes: int = 3,
    arch: str = "end2end",
) -> float:
    """Conv FLOPs of ONE window-batch body of the device scorer.

    ``n_stacks_2d``: 2D slice stacks actually computed per batch: wb*cols on
    the per-window path, (wb-1)*stride + cols - 2 + 2*wb with the in-batch
    dedup (``infer/device_pipeline.DeviceVolumeScorer._dedup_batch``).
    """
    from ..models import denseunet2d, denseunet3d
    from ..models.hybrid import HFFHead

    kw2d, kw3d = denseunet2d.PRESETS[preset], denseunet3d.PRESETS[preset]
    net2d = denseunet2d.DenseUNet2D(num_classes=num_classes, device="meta", **kw2d)
    f2d = conv_flops(net2d, (1, x, y, 3), bn_frozen=True, decoder_dropout=0.0)

    net3d = denseunet3d.DenseUNet3D(
        in_channels=1 + num_classes, num_classes=num_classes, device="meta", **kw3d
    )
    feat_width = kw2d.get("decoder_widths", denseunet2d.DECODER_WIDTHS)[-1]
    head = HFFHead(feat_width, num_classes=num_classes, device="meta")

    def tail(input3d, fea2d):
        feat3d, _ = net3d(input3d)
        return head(feat3d, fea2d, arch=arch)

    f3d = conv_flops(tail, (wb, x, y, cols, 1 + num_classes), (wb, x, y, cols, feat_width))
    return n_stacks_2d * f2d + f3d
