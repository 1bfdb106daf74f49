"""Weighted 3-class cross-entropy losses (counterpart of
hdenseunet_tpu/train/loss.py; reference loss.py).

    loss = -(1/N) * sum_i  w[y_i] * max(log p_{y_i}, log 1e-10)

over the N included voxels, through kernel K2 (``ops.wce.weighted_ce``).
The hybrid variant drops the two boundary z-slices from the loss (reference
loss.py:6-7) through the mask, so shapes stay static for any depth. Under a
data-parallel ``mesh`` the logits are this rank's rows and the loss is the
global batch's (train/loss.py:17-21 over a sharded batch).
"""
from __future__ import annotations

import torch

from ..core.mesh import axis_group
from ..ops.wce import weighted_ce

DEFAULT_CLASS_WEIGHTS = (0.78, 0.65, 8.57)  # bg / liver / tumor (loss.py:23)


def _flat_labels(logits, labels):
    if labels.dim() == logits.dim():
        labels = labels[..., 0]
    return labels.reshape(-1).to(torch.int32).contiguous()


def weighted_crossentropy_2d(logits, labels, weights=DEFAULT_CLASS_WEIGHTS, mesh=None):
    """2D-stage loss (reference loss.py:27-46 weighted_crossentropy_2ddense).

    logits: (B, H, W, C) float; labels: (B, H, W) or (B, H, W, 1) int.
    """
    c = logits.shape[-1]
    flat_labels = _flat_labels(logits, labels)
    mask = torch.ones(flat_labels.shape, dtype=torch.float32, device=logits.device)
    return weighted_ce(logits.reshape(-1, c), flat_labels, mask, weights, axis_group(mesh))


def weighted_crossentropy_hybrid(logits, labels, weights=DEFAULT_CLASS_WEIGHTS, mesh=None):
    """Hybrid-stage loss (reference loss.py:5-25): boundary z-slices excluded.

    logits: (B, H, W, D, C); labels: (B, H, W, D) or (B, H, W, D, 1) int.
    """
    d, c = logits.shape[3], logits.shape[-1]
    flat_labels = _flat_labels(logits, labels)
    z = torch.arange(d, device=logits.device)
    zmask = ((z >= 1) & (z < d - 1)).to(torch.float32)  # loss.py:6-7 for d=8
    mask = zmask.expand(logits.shape[:-1]).reshape(-1)
    return weighted_ce(logits.reshape(-1, c), flat_labels, mask, weights, axis_group(mesh))
