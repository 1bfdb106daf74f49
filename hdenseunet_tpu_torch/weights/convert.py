"""Keras-HDF5 conversion and warm-start weights by layer name (counterpart
of hdenseunet_tpu/weights/convert.py).

The reference seeds one stage from another with runtime HDF5 loading hacks
(by-name, ``by_gpu``, ``two_model``; Keras-2.0.8/keras/engine/topology.py:
2590-2630):

* plain by-name loading (:3107);
* ``by_gpu``: checkpoints written by a ``make_parallel``-wrapped model nest
  every real layer under a ``model_1`` group (:3171-3196);
* ``two_model``: the ``denseu161`` (2D) or ``auto3d_residual_conv`` (3D)
  subgroup of a full-model save (:3250-3302).

Here, as in the JAX package, all of that is an offline conversion: one pass
reads any of those layouts into a flat ``{layer: {leaf: array}}`` mapping
keyed by the reference graph's layer names (leaves by the names in the
``weight_names`` attrs, never by position), saved as an ``.npz`` of
``{layer}/{leaf}`` keys. Those files, and the port's checkpoint
directories, load into a model by layer name through the parameter bridge,
with every shape checked and every layer accounted for;
:func:`save_keras_hdf5` writes the other way.

The HDF5 functions (``load_keras_hdf5``, ``convert_checkpoint``,
``save_keras_hdf5``) are numpy and h5py only, copied from the JAX package
and pinned to the originals by tests. h5py is imported when one of them
runs; where it is not installed they raise ImportError, and the ``.npz``
written where it is installed is the way in.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import params as P
from ..train import checkpoint

SUBMODEL_2D = "denseu161"  # topology.py:3285 (by_flag=True)
SUBMODEL_3D = "auto3d_residual_conv"  # topology.py:3287 (by_flag=False)
MULGPU_GROUP = "model_1"  # topology.py:3196

_LEAF_ALIASES = {
    "kernel": "kernel",
    "bias": "bias",
    "gamma": "gamma",
    "beta": "beta",
    "moving_mean": "moving_mean",
    "moving_variance": "moving_variance",
    # Keras-1 era names that preprocess_weights_for_loading would shim
    "running_mean": "moving_mean",
    "running_std": "moving_variance",
}
_STATE_LEAVES = ("moving_mean", "moving_variance")


def h5py_module():
    """h5py, imported now; ImportError naming the .npz route without it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is required for Keras HDF5 conversion and is not installed. Convert "
            "the .h5 file where h5py is installed (python -m hdenseunet_tpu_torch "
            "convert-weights SRC DST.npz, or the JAX package's convert-weights) and pass "
            "the .npz of '{layer}/{leaf}' arrays to --init-from or --weights."
        ) from e
    return h5py


def _decode(x):
    return x.decode("utf8") if isinstance(x, bytes) else str(x)


def _parse_leaf(weight_name: str) -> str:
    """'conv1/kernel:0' -> 'kernel'; 'conv1_scale_gamma:0' -> 'gamma'."""
    name = weight_name.split(":")[0]
    if "/" in name:
        leaf = name.rsplit("/", 1)[1]
    else:
        leaf = name.rsplit("_", 1)[-1]
    if leaf not in _LEAF_ALIASES:
        raise ValueError(f"unrecognized weight leaf in {weight_name!r}")
    return _LEAF_ALIASES[leaf]


def _read_layer_group(group) -> dict:
    """One Keras layer group -> {leaf: np.ndarray}."""
    out = {}
    names = [_decode(n) for n in group.attrs.get("weight_names", [])]
    if names:
        for wname in names:
            out[_parse_leaf(wname)] = np.asarray(group[wname])
    else:  # groups without the attr: walk datasets
        def visit(path, obj):
            if hasattr(obj, "shape") and obj.shape is not None:
                out[_parse_leaf(path)] = np.asarray(obj)

        group.visititems(visit)
    return out


def load_keras_hdf5(path, submodel: str | None = None) -> dict:
    """Read a Keras-2.0.8 weights/model HDF5 into {layer: {leaf: array}}.

    ``submodel``: None for a flat by-name checkpoint; 'model_1' for
    make_parallel checkpoints; 'denseu161' / 'auto3d_residual_conv' to extract
    a nested submodel from a full-model save (the two_model paths).
    Auto-detects ``model_weights`` wrapping (full-model saves, topology.py:2615)
    and, when submodel is None, a sole nested container group.
    """
    h5py = h5py_module()
    weights: dict[str, dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f
        if "layer_names" not in g.attrs and "model_weights" in g:
            g = g["model_weights"]
        if submodel is not None:
            if submodel not in g:
                raise KeyError(
                    f"submodel group {submodel!r} not in {path} "
                    f"(has {list(g.keys())[:8]}...)"
                )
            g = g[submodel]
        layer_names = [_decode(n) for n in g.attrs.get("layer_names", [])] or list(
            g.keys()
        )
        for lname in layer_names:
            if lname not in g:
                continue
            sub = g[lname]
            leaves = _read_layer_group(sub)
            if leaves:
                weights[lname] = leaves
            else:
                # container layer (e.g. a nested Model): recurse one level
                for inner in sub:
                    inner_leaves = _read_layer_group(sub[inner])
                    if inner_leaves:
                        weights[inner] = inner_leaves
    return weights


def convert_checkpoint(
    hdf5_path,
    out_path,
    *,
    submodel: str | None = None,
):
    """Offline conversion: Keras HDF5 -> .npz of flat '{layer}/{leaf}' keys."""
    raw = load_keras_hdf5(hdf5_path, submodel=submodel)
    flat = {
        f"{lname}/{leaf}": arr for lname, leaves in raw.items() for leaf, arr in leaves.items()
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **flat)
    return sorted(flat)


def save_keras_hdf5(path, params, state) -> None:
    """Write (params, state) in Keras-2.0.8 by-name HDF5 layout.

    Enables round-trip tests and taking a model trained here *back* to the
    reference stack. Layout per save_weights_to_hdf5_group
    (topology.py:2847-2874): root attr ``layer_names``, one group per layer
    with attr ``weight_names`` and a dataset per weight.
    """
    h5py = h5py_module()
    merged: dict[str, dict[str, np.ndarray]] = {}
    for src in (params, state):
        for lname, leaves in src.items():
            merged.setdefault(lname, {}).update(
                {k: np.asarray(v) for k, v in leaves.items()}
            )
    order = ("gamma", "beta", "moving_mean", "moving_variance", "kernel", "bias")
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode("utf8") for n in merged]
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.0.8"
        for lname, leaves in merged.items():
            g = f.create_group(lname)
            wnames = []
            for leaf in sorted(leaves, key=lambda l: order.index(l) if l in order else 99):
                wname = f"{lname}/{leaf}:0"
                g.create_dataset(wname, data=leaves[leaf])
                wnames.append(wname.encode("utf8"))
            g.attrs["weight_names"] = wnames


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
    """Inverse of :func:`convert_checkpoint`: npz -> {layer: {leaf: array}}."""
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
