"""Space-to-depth execution of the 3D stem's stride-2 convolution
(counterpart of hdenseunet_tpu/models/s2d.py).

The 3D stem is a 7x7x7 stride-2 convolution of a 4-channel input: 4 input
channels a tap give a matrix unit a contraction of 4. Writing each kernel tap
p = 2q + r, the stride-2 convolution regroups by parity r into a stride-1
convolution over the 2^3 parity sub-grids x_r[m] = x_padded[2m + r], stacked
into 8·Cin channels, with a 4x4x4 kernel (each axis zero-padded from 7 to 8
taps and split into (q, r)):

    y[o] = sum_p w[p] x[2o + p - pad] = sum_r sum_q w[2q + r] x_r[o + q]

The same multiply-accumulate set as the direct convolution (the added taps
are zeros): outputs differ by float summation order only. The input and the
canonical kernel (F, Cin, kh, kw, kz) are repacked at forward time by
differentiable pads, reshapes and permutes, so checkpoints and gradients are
the direct stem's.
"""
from __future__ import annotations

import torch.nn.functional as F

from . import layers as L


def conv3d_s2d(conv: L.Conv, x, *, kernel_perm=(0, 1, 2)):
    """``conv``, a stride-2 3D convolution with an explicit padding, on x
    (B, C, S1, S2, S3) through the parity decomposition. ``kernel_perm``
    names the canonical (H, W, D) axis that each of x's spatial axes holds:
    (0, 1, 2) for canonical tensors, (2, 0, 1) for d-major ones
    (models/dmajor.py). Returns (B, F, O1, O2, O3), channels-last."""
    assert conv.stride == (2, 2, 2), f"s2d decomposition is for stride 2, got {conv.stride}"
    assert conv.dilation == (1, 1, 1), conv.dilation
    kk = tuple(conv.kernel_size[a] for a in kernel_perm)
    pd = tuple(L.norm_tuple(conv.padding, 3)[a] for a in kernel_perm)
    b, cin = int(x.shape[0]), int(x.shape[1])
    kq = tuple((k + 1) // 2 for k in kk)
    out_sp, halves, pads = [], [], []
    for ax in range(3):
        s_in = int(x.shape[2 + ax])
        o_n = (s_in + 2 * pd[ax] - kk[ax]) // 2 + 1
        need = 2 * (o_n - 1) + kk[ax]  # highest padded index read + 1
        half = max(-(-need // 2), o_n - 1 + kq[ax])
        out_sp.append(o_n)
        halves.append(half)
        pads.append((pd[ax], 2 * half - s_in - pd[ax]))
    # the model's FLOPs are the direct conv's; the zero taps are execution
    conv.count(b * float(out_sp[0] * out_sp[1] * out_sp[2]), cin)

    # input phases: (B, 2h1, 2h2, 2h3, C) -> (B, h1, h2, h3, 8C), the
    # channel order (r1, r2, r3, c), r the parity along each axis
    h1, h2, h3 = halves
    xs = F.pad(x, L._pad_arg(pads)).movedim(1, -1)
    xs = xs.reshape(b, h1, 2, h2, 2, h3, 2, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
    xs = xs.reshape(b, h1, h2, h3, 8 * cin).movedim(-1, 1)

    # kernel phases: each tap axis padded to 2kq and split (q, r); (r1, r2,
    # r3, cin) merged into the input channels in the input's order
    w = conv.kernel.to(x.dtype).permute(0, 1, *(2 + a for a in kernel_perm))
    w = F.pad(w, L._pad_arg([(0, 2 * q - k) for q, k in zip(kq, kk)]))
    nf = int(w.shape[0])
    w = w.reshape(nf, cin, kq[0], 2, kq[1], 2, kq[2], 2).permute(0, 3, 5, 7, 1, 2, 4, 6)
    w = L.channels_last(w.reshape(nf, 8 * cin, *kq))

    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv3d(L.channels_last(xs), w, bias)
    return L.channels_last(y[:, :, : out_sp[0], : out_sp[1], : out_sp[2]])
