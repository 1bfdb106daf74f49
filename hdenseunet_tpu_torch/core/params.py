"""Parameter bridge between the JAX pytree and the port's modules.

Counterpart of hdenseunet_tpu/core/module.py's parameter handling. The JAX
package keeps ``params`` and ``state`` as flat ``{layer: {leaf: array}}``
dicts with the reference graph's layer names ('conv2_1_x1', 'bn_up0',
'3dconv1', 'fianl_conv' [sic], '2d3dclassifer' [sic]). The port's models are
``nn.ModuleDict``s keyed by the same names, so the bridge is a rename-free
walk. Only conv kernels change layout:

* 2D: HWIO -> OIHW;
* 3D: (kh, kw, kd, I, O) -> (O, I, kh, kw, kd), keeping the JAX spatial
  order (H, W, D).

Parameters map to ``nn.Parameter``s and ``state`` (BN moving statistics) to
buffers. The map is a bijection: :func:`from_numpy` raises on any layer,
leaf or shape that is missing on either side, and :func:`to_numpy` is its
inverse. Checkpoints written by hdenseunet_tpu/weights/convert.py
(``load_npz_checkpoint``) load the same way, and the port's own checkpoints
and warm starts speak this layout too.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import layers as L

_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_JAX = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def layers(model: nn.Module) -> dict[str, nn.Module]:
    """{reference layer name: layer module} over every ModuleDict in model."""
    out: dict[str, nn.Module] = {}
    for table in model.modules():
        if isinstance(table, nn.ModuleDict):
            for name, layer in table.items():
                if name in out:
                    raise ValueError(f"layer name {name!r} appears twice")
                out[name] = layer
    return out


def leaves(layer: nn.Module) -> dict[str, torch.Tensor]:
    """A layer's parameters and buffers by leaf name."""
    return {
        **dict(layer.named_parameters(recurse=False)),
        **dict(layer.named_buffers(recurse=False)),
    }


def _jax_shape(leaf: str, shape) -> tuple:
    shape = tuple(int(s) for s in shape)
    if leaf == "kernel" and len(shape) in _TO_JAX:
        return tuple(shape[i] for i in _TO_JAX[len(shape)])
    return shape


def spec(model: nn.Module):
    """({layer: {leaf: shape}} of params, same of state), in JAX layout."""
    params: dict = {}
    state: dict = {}
    for name, layer in layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            params.setdefault(name, {})[leaf] = _jax_shape(leaf, t.shape)
        for leaf, t in layer.named_buffers(recurse=False):
            state.setdefault(name, {})[leaf] = _jax_shape(leaf, t.shape)
    return params, state


def _shapes(tree) -> dict:
    return {n: {l: tuple(np.shape(a)) for l, a in d.items()} for n, d in tree.items()}


def _diff(kind: str, want: dict, got: dict) -> list[str]:
    flat_w = {(n, l): s for n, d in want.items() for l, s in d.items()}
    flat_g = {(n, l): s for n, d in got.items() for l, s in d.items()}
    out = [f"{kind} missing {k}" for k in sorted(flat_w.keys() - flat_g.keys())]
    out += [f"{kind} unexpected {k}" for k in sorted(flat_g.keys() - flat_w.keys())]
    out += [
        f"{kind} {k}: model {flat_w[k]} vs pytree {flat_g[k]}"
        for k in sorted(flat_w.keys() & flat_g.keys())
        if flat_w[k] != flat_g[k]
    ]
    return out


@torch.no_grad()
def from_numpy(model: nn.Module, params, state) -> nn.Module:
    """Load a JAX ``(params, state)`` pytree (numpy or JAX arrays) into model."""
    want_p, want_s = spec(model)
    problems = _diff("param", want_p, _shapes(params)) + _diff("state", want_s, _shapes(state))
    if problems:
        raise ValueError("pytree does not match the model:\n  " + "\n  ".join(problems[:20]))
    for name, layer in layers(model).items():
        for leaf, t in leaves(layer).items():
            src = params[name][leaf] if leaf in params.get(name, {}) else state[name][leaf]
            t.copy_(to_torch_layout(leaf, src))
    return L.unfreeze_bn_scale(model)  # a serving fold of the old weights is stale


def to_jax_layout(leaf: str, t: torch.Tensor) -> np.ndarray:
    """One leaf as a float32 host array of its own, in JAX layout."""
    arr = t.detach().to("cpu", torch.float32, copy=True).numpy()
    if leaf == "kernel" and arr.ndim in _TO_JAX:
        arr = np.ascontiguousarray(arr.transpose(_TO_JAX[arr.ndim]))
    return arr


def to_torch_layout(leaf: str, arr) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`: a float32 CPU tensor of its own."""
    arr = np.array(arr, dtype=np.float32)
    if leaf == "kernel" and arr.ndim in _TO_TORCH:
        arr = np.ascontiguousarray(arr.transpose(_TO_TORCH[arr.ndim]))
    return torch.from_numpy(arr)


@torch.no_grad()
def to_numpy(model: nn.Module):
    """The JAX ``(params, state)`` pytree of model, float32 numpy arrays in
    JAX layout: the inverse of :func:`from_numpy`."""
    params: dict = {}
    state: dict = {}
    for name, layer in layers(model).items():
        for leaf, t in layer.named_parameters(recurse=False):
            params.setdefault(name, {})[leaf] = to_jax_layout(leaf, t)
        for leaf, t in layer.named_buffers(recurse=False):
            state.setdefault(name, {})[leaf] = to_jax_layout(leaf, t)
    return params, state

