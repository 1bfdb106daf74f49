"""Warm-start weights by layer name (the warm-start half of
hdenseunet_tpu/weights/convert.py).

The reference seeds one stage from another with runtime HDF5 loading hacks
(by-name, ``by_gpu``, ``two_model``; Keras-2.0.8/keras/engine/topology.py:
2590-2630). The JAX package turns them into an offline conversion to
``.npz`` files of flat ``{layer}/{leaf}`` keys; here those files, and the
port's checkpoint directories, load into a model by layer name through the
parameter bridge, with every shape checked and every layer accounted for.

The HDF5 half (``load_keras_hdf5``, ``save_keras_hdf5``,
``convert_checkpoint``) needs h5py and stays with the JAX package, which
converts a Keras HDF5 file to the ``.npz`` read here.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import params as P
from ..train import checkpoint

_STATE_LEAVES = ("moving_mean", "moving_variance")


def match_to_model(raw: dict, model, *, strict_shapes: bool = True) -> dict:
    """Load ``{layer: {leaf: array}}`` weights into ``model`` by layer/leaf
    name (convert.py:127-152) and return the report: the layers loaded,
    skipped (no leaf of theirs is in the model) and shape-mismatched — the
    auditable equivalent of the reference's silent by-name skip
    (topology.py:3107). A mismatch raises under ``strict_shapes``, before
    the model changes; otherwise that leaf keeps its value.
    """
    params, state = P.to_numpy(model)
    report = {"loaded": [], "skipped": [], "mismatched": []}
    for lname, leaves in raw.items():
        hit = False
        for leaf, value in leaves.items():
            target = state if leaf in _STATE_LEAVES else params
            if lname in target and leaf in target[lname]:
                want = target[lname][leaf].shape
                if tuple(want) != tuple(value.shape):
                    report["mismatched"].append(f"{lname}/{leaf}: {value.shape} -> {want}")
                    if strict_shapes:
                        raise ValueError(report["mismatched"][-1])
                    continue
                target[lname][leaf] = np.asarray(value, np.float32)
                hit = True
        report["loaded" if hit else "skipped"].append(lname)
    P.from_numpy(model, params, state)
    return report


def load_npz_checkpoint(path) -> dict:
    """npz of '{layer}/{leaf}' keys -> {layer: {leaf: array}}."""
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            lname, leaf = key.rsplit("/", 1)
            out.setdefault(lname, {})[leaf] = z[key]
    return out


def load_checkpoint_weights(ckpt_dir, *, best: bool = False) -> dict:
    """A checkpoint directory of the port -> {layer: {leaf: array}}.

    The newest (or best-loss, ``best=True``) save; parameters and BN
    statistics are merged into the same by-name layout ``load_npz_checkpoint``
    produces, so a cross-stage warm start (reference train_hybrid.py:146
    seeding the hybrid from a 2D run) takes a training checkpoint directory
    as it is.
    """
    base = Path(ckpt_dir).absolute()
    if best:
        base = base / "best"
    steps = checkpoint.step_files(base)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {base}")
    payload = checkpoint.load(steps[max(steps)])
    merged: dict[str, dict[str, np.ndarray]] = {}
    for field in ("params", "bn_state"):
        for lname, leaves in payload[field].items():
            merged.setdefault(lname, {}).update({k: v.numpy() for k, v in leaves.items()})
    return merged


def load_init_weights(path, *, best: bool = False) -> dict:
    """Dispatch --init-from: .npz file or checkpoint directory."""
    p = Path(path)
    if p.is_dir():
        return load_checkpoint_weights(p, best=best)
    if p.suffix == ".npz":
        return load_npz_checkpoint(p)
    raise SystemExit(
        f"--init-from expects a converted .npz or a checkpoint directory, got: {path}"
    )
