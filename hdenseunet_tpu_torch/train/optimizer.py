"""Optimizer with staged freezing (counterpart of
hdenseunet_tpu/train/optimizer.py).

SGD with Nesterov momentum: ``torch.optim.SGD(lr, momentum, nesterov=True)``
with no dampening and no weight decay equals ``optax.sgd(nesterov=True)``.
Both step by ``-lr * (g + m * buf)`` with ``buf = m * buf + g``, which is
the reference's Keras SGD (Keras-2.0.8/keras/optimizers.py:130-194) up to
the v = -lr*u substitution. Every momentum buffer is made as zeros with the
optimizer, as optax's trace is: ``0.9 * 0 + g == g``, so the first step is
bit-equal to torch's clone of the first gradient, and the buffers are
written in place from then on, never rebound, as a captured CUDA graph of
the step needs (``train/trainer.py``).

Staged freezing: a frozen leaf gets ``requires_grad=False`` and stays out of
the optimizer, the counterpart of optax's ``set_to_zero`` (no update, no
momentum buffer). The trainable sets per stage come from
``models.hybrid.trainable_predicate``. In '3dpart' the whole 2D branch is
frozen, so autograd records nothing there and the branch runs as under
``torch.no_grad()``; the updates are the same.
"""
from __future__ import annotations

import torch

from ..core import params as P
from ..models import hybrid


def trainable_labels(model: torch.nn.Module, arch: str) -> dict:
    """{layer: {leaf: 'train' | 'freeze'}} over the model's parameters."""
    pred = hybrid.trainable_predicate(arch)
    return {
        name: {
            leaf: ("train" if pred(name, leaf) else "freeze")
            for leaf, _ in layer.named_parameters(recurse=False)
        }
        for name, layer in P.layers(model).items()
    }


def make_optimizer(
    model: torch.nn.Module, arch: str, lr: float, momentum: float = 0.9, nesterov: bool = True
):
    """(optimizer, labels) for the stage ('2d' | '3dpart' | 'end2end'); sets
    ``requires_grad`` on every parameter from the labels."""
    labels = trainable_labels(model, arch)
    trainable = []
    for name, layer in P.layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            t.requires_grad_(labels[name][leaf] == "train")
            if t.requires_grad:
                trainable.append(t)
    opt = torch.optim.SGD(
        trainable, lr=lr, momentum=momentum, dampening=0.0, weight_decay=0.0, nesterov=nesterov
    )
    if momentum:
        for t in trainable:
            opt.state[t]["momentum_buffer"] = torch.zeros_like(t, memory_format=torch.preserve_format)
    return opt, labels


def count_trainable(model: torch.nn.Module, labels: dict) -> int:
    total = 0
    for name, layer in P.layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            if labels[name][leaf] == "train":
                total += t.numel()
    return total
