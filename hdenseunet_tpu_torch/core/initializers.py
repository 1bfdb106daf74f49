"""Seeded parameter initialisation (counterpart of hdenseunet_tpu/core/initializers.py).

The same distributions as the JAX package: glorot_uniform for convs,
N(0, 0.05) for ``init="normal"`` (the 2D decoder), ones/zeros for BN and
Scale, BN moving statistics 0/1. Values are drawn on the CPU from one
``torch.Generator`` in sorted (layer, leaf) order, then copied to wherever
the parameter lives, so a seed gives the same weights on every device. The
numbers differ from ``jax.random``'s; only the scale of the activations has
to match the JAX package's random-init runs.
"""
from __future__ import annotations

import math

import torch

from . import params as P


def _fans(shape):
    """fan_in/fan_out for kernels stored (O, I, *k), or (n,) vectors."""
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    receptive = math.prod(int(d) for d in shape[2:])
    return int(shape[1]) * receptive, int(shape[0]) * receptive


def glorot_uniform(shape, generator):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def normal05(shape, generator):
    """Keras-2 'normal': RandomNormal(mean=0, stddev=0.05)."""
    return torch.empty(shape).normal_(0.0, 0.05, generator=generator)


_REGISTRY = {
    "glorot_uniform": glorot_uniform,
    "normal": normal05,
    "zeros": lambda shape, generator: torch.zeros(shape),
    "ones": lambda shape, generator: torch.ones(shape),
}


@torch.no_grad()
def init_model(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter and BN statistic of ``model`` from ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    for name, layer in sorted(P.layers(model).items()):
        for leaf, tensor in sorted(P.leaves(layer).items()):
            tensor.copy_(_REGISTRY[layer.inits[leaf]](tuple(tensor.shape), generator))
    return model
