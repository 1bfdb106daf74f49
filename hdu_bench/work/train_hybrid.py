"""Work counts of a training step of H-DenseUNet's end-to-end stage, from
the reference's shapes on the meta device (``counts.py``'s rule), and K1's
bound in it.

* :func:`train_step`: 3 x (the 2D network's forward FLOPs at batch x depth
  slices + batch x the 3D branch and head of one window): a forward, and a
  backward of twice the forward. The 3D branch's own classifier feeds
  nothing and is not counted; recomputation is not counted.
* :func:`k1_bound_s`: the least time K1 needs in one step. Every
  BN-Scale-ReLU of the 2D branch is frozen, so the program runs each
  through K1, once forward (x in, y out) and once backward (g and x in, dx
  out: the ReLU's mask follows from x and the affine, and x also gives the
  trained Scale's gradients): 10 bytes an element at bfloat16, over the
  card's HBM rate. The elements are those of every ``bn_scale_relu`` output
  in a traversal of the reference's 2D forward (:func:`k1_elements`); the
  3D branch and the head have live statistics and no K1. A recomputed
  forward is not counted.
"""
from __future__ import annotations

from unittest import mock

from ..reference import models as R
from . import counts

K1_BYTES = 10  # bfloat16: 2 x 2 bytes forward, 3 x 2 backward


def train_step(cfg, batch: int, size: int) -> float:
    """The step's FLOPs at ``batch`` windows of ``size`` x ``size`` x the
    configuration's depth (``infer.input_cols``)."""
    depth = cfg["infer"]["input_cols"]
    f2d = counts.forward_2d(cfg, batch * depth, size, prefix="net2d.").flops
    return 3.0 * (f2d + batch * counts.window_3d(cfg, size, size).flops)


def k1_elements(cfg, slices: int, size: int) -> int:
    """Elements out of every BN-Scale-ReLU of the reference's 2D forward at
    ``slices`` slices of ``size`` x ``size``."""
    seen = []
    inner = R.bn_scale_relu

    def counted(*args, **kwargs):
        y = inner(*args, **kwargs)
        seen.append(y.numel())
        return y

    with mock.patch.object(R, "bn_scale_relu", counted):
        counts.forward_2d(cfg, slices, size, prefix="net2d.")
    return sum(seen)


def k1_bound_s(cfg, slices: int, size: int, pk: dict | None):
    """K1's least seconds in a step (module docstring), or None without the
    card's peaks."""
    if pk is None:
        return None
    return K1_BYTES * k1_elements(cfg, slices, size) / pk["hbm_bytes_per_s"]
