#!/usr/bin/env python3
"""Time K5 (``affine_gemm``) of several checkouts of the port in turns, on
one CUDA card.

    python3 compare_k5.py [--rounds 2] DIR [DIR ...]

Each DIR holds a checkout of this repository, for example
``git archive COMMIT | tar -x -C build/turns/COMMIT``, or ``.`` for this
one. Every round runs each checkout once, in the order given, in a process
of its own started in that checkout, which builds that checkout's kernels
and times, through its own ``chip_smoke`` (``k5_shapes``, ``k5_case``,
``cuda_ms``, ``cold_ms``), K5 at each served shape of a window batch, warm
and with the L2 flushed, and the unfused chain it replaced (K1, cuDNN's
1x1 convolution, K1 on the concatenation) warm, and K5's host time a call
("host", queued while a sleep kernel holds the stream). It prints each turn's times
and per checkout the median of each time over the rounds, every line with
the card's name and power limit. It raises without a card and catches
nothing.
"""
from __future__ import annotations

from compare_cc import main

TURN = """
import json, time, torch
import torch.nn.functional as F
import chip_smoke as S
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.ops import affine_gemm as K5, fused_affine as K1
gen = torch.Generator(device="cuda").manual_seed(S.SEED + 15)
out = {}
for label, rows, k, ld, n, epi, ndim in S.k5_shapes():
    x, w, args = S.k5_case(rows, k, ld, n, epi, ndim, torch.bfloat16, gen)
    kernel = lambda: K5.affine_gemm(x, w, *args)
    conv = F.conv2d if ndim == 4 else F.conv3d
    xc, wc = L.channels_last(x), w.view(n, k, *[1] * (ndim - 2))
    def chain():
        y = conv(K1.affine_relu(xc, args[0], args[1]), wc)
        return K1.affine_relu(y, args[2], args[3]) if epi else y
    out[label] = S.cuda_ms(kernel)
    out[label + " L2 flushed"] = S.cold_ms(kernel)
    out[label + " chain"] = S.cuda_ms(chain)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(50):
        kernel()
    out[label + " host"] = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    del x, w, args, xc
print(json.dumps(out))
"""


if __name__ == "__main__":
    main(TURN, __doc__)
