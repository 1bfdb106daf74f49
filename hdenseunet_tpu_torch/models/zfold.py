"""z-folded execution of the 3D branch: every op runs on (B·D, C, H, W)
(counterpart of hdenseunet_tpu/models/zfold.py).

The folded tensor is (B·D, C, H, W) in ``channels_last`` memory, which is
the JAX fold's (B·D, H, W, C): the CT depth rides the batch axis, the fold
the hybrid already uses to feed its 2D branch, and every 3D op becomes a 2D
one:

* ``conv3d``: a (kh, kw, kz) convolution is ONE 2D convolution whose output
  channels pack the kz z-taps (weight (kz·F, Cin, kh, kw), channel t·F + f),
  then kz z-shifted adds, and the bias after them. The same
  multiply-accumulate set as the direct convolution: the result differs by
  float summation order only;
* 1x1x1 convolutions, (2,2,1) and (3,3,3) pools and (2,2,1) upsamples are 2D
  ops under the fold; (2,2,2) ones also reshape the folded batch axis;
* BN, Scale, ReLU, dropout and concatenation are per element or per channel:
  BN's batch statistics reduce over the same elements.

The canonical kernel (F, Cin, kh, kw, kz) is repacked at forward time, so
checkpoints and the HDF5 converter are the direct path's. Each function
takes and returns the current depth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L

# a tap-packed intermediate larger than this runs window by window, or over
# output-z chunks when one window alone is larger (zfold.py:36-39)
_MAX_PACK_BYTES = 1 << 30


def fold(x):
    """(B, C, H, W, D) -> ((B·D, C, H, W) channels-last, B, D)."""
    b, c, h, w, d = x.shape
    xf = x.movedim(1, -1).permute(0, 3, 1, 2, 4).reshape(b * d, h, w, c)
    return xf.movedim(-1, 1), b, d


def unfold(xf, b, d):
    """(B·D, C, H, W) -> (B, C, H, W, D), channels-last in memory."""
    bd, c, h, w = xf.shape
    assert bd == b * d, (xf.shape, b, d)
    y = xf.movedim(1, -1).reshape(b, d, h, w, c).permute(0, 2, 3, 1, 4)
    return y.contiguous().movedim(-1, 1)


def _z_pads(depth, kz, stride_z, padding):
    if padding == "same":
        out = -(-depth // stride_z)  # ceil
        total = max((out - 1) * stride_z + kz - depth, 0)
        return total // 2, total - total // 2
    if padding == "valid":
        return 0, 0
    p = L.norm_tuple(padding, 3)[2]  # explicit: int or per-axis tuple
    return p, p


def _shifted_sum(y, kz, sz, d_out):
    """out[:, o] = sum_t y[:, sz·o + t, ..., t, :] over the taps t in order,
    y (N, Z, H', W', kz, F) -> (N, d_out, H', W', F)."""
    out = None
    for t in range(kz):
        part = y[:, t : t + sz * (d_out - 1) + 1 : sz, :, :, t]
        out = part if out is None else out + part
    return out


def conv3d(conv: L.Conv, xf, b, d):
    """``conv`` (its canonical parameters, stride and padding) on a folded
    tensor of b windows of depth d. Returns (yf, new depth).

    The packed intermediate holds kz·F channels at every z position; past
    ``_MAX_PACK_BYTES`` the windows run one by one, or, when one window alone
    is past it, output z runs in equal chunks, each reading its sz·(dc-1)+kz
    input slices (the z padding applied first: a zero slice convolves to
    zero), with the same arithmetic."""
    kh, kw, kz = conv.kernel_size
    sh, sw, sz = conv.stride
    assert conv.dilation == (1, 1, 1), conv.dilation
    padding = conv.padding
    cin, nf = int(xf.shape[1]), int(conv.kernel.shape[0])
    pad_hw = padding if isinstance(padding, (str, int)) else tuple(padding)[:2]
    pads_hw = L.conv_padding(xf.shape[2:], (kh, kw), (sh, sw), pad_hw)
    pz_lo, pz_hi = _z_pads(d, kz, sz, padding)
    d_out = (d + pz_lo + pz_hi - kz) // sz + 1
    hw_out = [
        (int(xf.shape[2 + i]) + lo + hi - k) // s + 1
        for i, ((lo, hi), k, s) in enumerate(zip(pads_hw, (kh, kw), (sh, sw)))
    ]
    # the direct conv's FLOPs; the strided stem's recomputed z rows are execution
    conv.count(b * float(hw_out[0] * hw_out[1]) * d_out, cin)

    # the kz z-taps packed into the output channels of one 2D conv, t·F + f
    wp = conv.kernel.to(xf.dtype).permute(4, 0, 1, 2, 3).reshape(kz * nf, cin, kh, kw)
    wp = L.channels_last(wp)
    symmetric = all(lo == hi for lo, hi in pads_hw)

    def conv2d(x4):
        if symmetric:
            return F.conv2d(x4, wp, None, (sh, sw), [lo for lo, _ in pads_hw])
        return F.conv2d(L.channels_last(F.pad(x4, L._pad_arg(pads_hw))), wp, None, (sh, sw))

    def one_shot(x4, nb):
        """Packed conv and z-shifted adds of nb windows of depth d."""
        y = conv2d(x4)
        if kz == 1 and sz == 1:
            return y.movedim(1, -1).reshape(nb, d, *hw_out, nf)
        y = y.movedim(1, -1).reshape(nb, d, *hw_out, kz, nf)
        if pz_lo or pz_hi:
            y = F.pad(y, (0, 0, 0, 0, 0, 0, 0, 0, pz_lo, pz_hi))
        return _shifted_sum(y, kz, sz, d_out)

    def z_chunked():
        x5 = xf.movedim(1, -1).reshape(b, d, *xf.shape[2:], cin)
        if pz_lo or pz_hi:
            x5 = F.pad(x5, (0, 0, 0, 0, 0, 0, pz_lo, pz_hi))
        per_z = b * hw_out[0] * hw_out[1] * kz * nf * itemsize
        dc = 1
        for cand in range(1, d_out + 1):
            if d_out % cand == 0 and (sz * (cand - 1) + kz) * per_z <= _MAX_PACK_BYTES:
                dc = cand
        din = sz * (dc - 1) + kz
        chunks = []
        for z0 in range(0, sz * d_out, sz * dc):
            xs = x5[:, z0 : z0 + din].reshape(b * din, *x5.shape[2:]).movedim(-1, 1)
            y = conv2d(xs).movedim(1, -1).reshape(b, din, *hw_out, kz, nf)
            chunks.append(_shifted_sum(y, kz, sz, dc))
        return torch.cat(chunks, dim=1)

    itemsize = xf.element_size()
    per_window = (d + pz_lo + pz_hi) * hw_out[0] * hw_out[1] * kz * nf * itemsize
    if kz > 1 and b * per_window > _MAX_PACK_BYTES:
        if b > 1 and per_window <= _MAX_PACK_BYTES:
            out = torch.cat([one_shot(xf[i * d : (i + 1) * d], 1) for i in range(b)])
        else:
            out = z_chunked()
    else:
        out = one_shot(xf, b)
    out = out.reshape(b * d_out, *hw_out, nf).movedim(-1, 1)
    if conv.bias is not None:
        out = out + conv.bias.to(out.dtype).view(1, -1, 1, 1)
    return L.channels_last(out), d_out


def max_pool(xf, b, d, window, stride, pad=0):
    """Zero-padded VALID 3D max pool (layers.max_pool) on a folded tensor.
    Returns (yf, new depth)."""
    wh, ww, wz = L.norm_tuple(window, 3)
    sh, sw, sz = L.norm_tuple(stride, 3)
    ph, pw, pz = L.norm_tuple(pad, 3)
    y = L.max_pool(xf, (wh, ww), (sh, sw), pad=(ph, pw))
    if wz == 1 and sz == 1:
        return y, d
    d_out = (d + 2 * pz - wz) // sz + 1
    c, hh, ww2 = y.shape[1:]
    y5 = y.movedim(1, -1).reshape(b, d, hh, ww2, c)
    if pz:  # zero padding (Keras ZeroPadding3D), as layers.max_pool
        y5 = F.pad(y5, (0, 0, 0, 0, 0, 0, pz, pz))
    out = None
    for t in range(wz):
        part = y5[:, t : t + sz * (d_out - 1) + 1 : sz]
        out = part if out is None else torch.maximum(out, part)
    return out.reshape(b * d_out, hh, ww2, c).movedim(-1, 1), d_out


def avg_pool(xf, b, d, window, stride):
    """VALID 3D average pool on a folded tensor: the 2D pool, then the two z
    halves averaged in float32 and rounded once. Returns (yf, new depth)."""
    wh, ww, wz = L.norm_tuple(window, 3)
    sh, sw, sz = L.norm_tuple(stride, 3)
    y = L.avg_pool(xf, (wh, ww), (sh, sw))
    if wz == 1 and sz == 1:
        return y, d
    assert (wz, sz) == (2, 2), (wz, sz)
    d_out = d // 2
    c, hh, ww2 = y.shape[1:]
    y6 = y.movedim(1, -1).reshape(b, d_out, 2, hh, ww2, c)
    out = ((y6[:, :, 0].float() + y6[:, :, 1].float()) / 2.0).to(y.dtype)
    return out.reshape(b * d_out, hh, ww2, c).movedim(-1, 1), d_out


def upsample_nearest(xf, b, d, factors):
    """Nearest upsample on a folded tensor. Returns (yf, new depth)."""
    fh, fw, fz = L.norm_tuple(factors, 3)
    y = L.upsample_nearest(xf, (fh, fw))
    if fz == 1:
        return y, d
    c, hh, ww2 = y.shape[1:]
    y5 = y.movedim(1, -1).reshape(b, d, 1, hh, ww2, c).expand(b, d, fz, hh, ww2, c)
    return y5.reshape(b * d * fz, hh, ww2, c).movedim(-1, 1), d * fz
