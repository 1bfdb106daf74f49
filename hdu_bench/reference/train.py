"""Plain reference of a training step of the 2D stage (the reference
repository's train_2ddense.py with loss.py's weighted cross-entropy and
Keras's SGD with Nesterov momentum), in float32 PyTorch autograd.

    loss = -(1/N) sum_i w[y_i] max(log softmax(z_i)[y_i], ln 1e-10)

over every pixel of the batch, with live BatchNorm statistics and dropout
0.3 before the last decoder BN (``models.forward_2d``); then for every
leaf, ``buf = m buf + g`` and ``p -= lr (g + m buf)`` (Keras's update with
its velocity written as -lr buf), the buffers starting at zero, and every
BN's moving statistics ``0.99 moving + 0.01 batch``.
"""
from __future__ import annotations

import math

import torch

from . import models as R

LOG_CLIP = math.log(1e-10)


def weighted_ce(logits, labels, weights):
    """logits (N, C, H, W), labels (N, H, W) int -> the mean weighted loss."""
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = logp.gather(1, labels.long().unsqueeze(1)).squeeze(1).clamp_min(LOG_CLIP)
    return -(weights[labels.long()] * picked).mean()


class Trainer:
    """The reference's optimizer state over a parameter dict ``P`` (copied);
    BN moving statistics are kept but not trained."""

    def __init__(self, P: dict, cfg, ops):
        self.cfg, self.ops = cfg, ops
        tr = cfg["train"]
        self.lr, self.m = tr["lr"], tr["momentum"]
        self.weights = torch.tensor(tr["loss_weights"], dtype=torch.float32,
                                    device=next(iter(P.values())).device)
        self.params = {k: v.detach().clone().requires_grad_(not _is_stat(k)) for k, v in P.items()}
        self.buf = {k: torch.zeros_like(v) for k, v in self.params.items() if v.requires_grad}

    def step(self, image, label, seed: int):
        """One step on image (N, H, W, 3) float32 and label (N, H, W);
        returns (loss, {key: the gradient the optimizer got})."""
        P = self.params
        for v in P.values():
            v.grad = None
        train = R.TrainStep(seed, self.cfg["train"]["decoder_dropout"])
        x = image.float().permute(0, 3, 1, 2).contiguous()
        _, logits = R.forward_2d(self.ops, x, P, self.cfg, train)
        loss = weighted_ce(logits, label, self.weights)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for k, buf in self.buf.items():
                g = P[k].grad
                grads[k] = g
                buf.mul_(self.m).add_(g)
                P[k].sub_(self.lr * (g + self.m * buf))
            for name, (mean, var) in train.stats.items():
                P[f"{name}.moving_mean"].mul_(0.99).add_(0.01 * mean)
                P[f"{name}.moving_variance"].mul_(0.99).add_(0.01 * var)
        return float(loss.detach()), grads


def _is_stat(key: str) -> bool:
    return key.endswith(".moving_mean") or key.endswith(".moving_variance")
