"""Seeded weights of a configuration, made on the device in three calls.

Every key of ``reference.models.layer_table`` gets its tensor from one of
three flat draws of a device ``torch.Generator`` seeded with the run's
seed: uniform [-1, 1) for the Glorot-uniform kernels, the biases and the
BN and Scale leaves, and normal for the kernels the reference graph draws
from N(0, 0.05) (the 2D decoder's). BN and Scale leaves sit near the
identity (gamma and the moving variance in [0.8, 1.2), beta and the moving
mean in [-0.1, 0.1)), so that folding them is exercised; biases lie in
[-0.05, 0.05). The program receives the dict through its state dict, and
the reference reads the same dict.
"""
from __future__ import annotations

import math

import torch

from .reference.models import glorot_limit, layer_table

# init kind -> (draw, scale, offset): value = offset + scale * draw
_KINDS = {
    "glorot": ("uniform", None, 0.0),
    "normal": ("normal", 0.05, 0.0),
    "bias": ("uniform", 0.05, 0.0),
    "gamma": ("uniform", 0.2, 1.0),
    "beta": ("uniform", 0.1, 0.0),
    "mean": ("uniform", 0.1, 0.0),
    "var": ("uniform", 0.2, 1.0),
}


@torch.no_grad()
def make_weights(cfg, seed: int, device) -> dict:
    """{key: float32 tensor on ``device``} for every leaf of the
    configuration's model, a function of ``seed`` alone."""
    table = layer_table(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    need = {"uniform": 0, "normal": 0}
    for _, shape, init in table:
        need[_KINDS[init][0]] += math.prod(shape)
    flat = {
        "uniform": torch.rand(need["uniform"], generator=gen, device=device).mul_(2).sub_(1),
        "normal": torch.randn(need["normal"], generator=gen, device=device),
    }
    at = {"uniform": 0, "normal": 0}
    out = {}
    for key, shape, init in table:
        draw, scale, offset = _KINDS[init]
        n = math.prod(shape)
        t = flat[draw][at[draw] : at[draw] + n].view(shape)
        at[draw] += n
        scale = glorot_limit(shape) if scale is None else scale
        out[key] = t.mul_(scale).add_(offset)
    return out

