"""Step-indexed checkpoints of the whole train state (counterpart of
hdenseunet_tpu/train/checkpoint.py, which uses orbax).

A save holds everything a resume needs to continue bit for bit: the
parameters and BN moving statistics, the optimizer's momentum buffers, the
step and the dropout generator's state. Parameters, statistics and momentum
are kept as ``{layer: {leaf: tensor}}`` in the JAX package's layout
(``core/params.py``), the layout of its ``.npz`` weight files, so a
checkpoint directory also serves as warm-start weights
(``weights/convert.load_checkpoint_weights``).

Layout: ``<dir>/step-<N>.pt`` (``torch.save``, read back with
``weights_only=True``), the ``max_to_keep`` newest kept; and, as the
reference's ModelCheckpoint(monitor='loss', save_best_only, mode='min')
does (Keras-2.0.8/keras/callbacks.py:335-430), a one-slot ``<dir>/best/``
holding the save with the lowest finite monitored loss, its loss beside it
in ``step-<N>.json``. A fresh :class:`Checkpointer` over the same directory
reads that loss back. Every file is written under a temporary name and
renamed into place, so a save cut short never leaves half a file as the
newest step. Saves are synchronous.

Under a data-parallel ``mesh`` every rank holds the same state: rank 0
writes and the others wait for it at a barrier, and every rank restores the
same file. The format does not depend on the number of ranks, so a save
made by two ranks resumes in one process bit for bit, and the other way
round.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from ..core import params as P
from ..core.mesh import axis_group, axis_rank

_BEST_SUBDIR = "best"
_STEP_FILE = re.compile(r"step-(\d+)\.pt")


def step_files(directory) -> dict[int, Path]:
    """{step: file} of the saves in directory, in step order."""
    found = {}
    for p in Path(directory).glob("step-*.pt"):
        m = _STEP_FILE.fullmatch(p.name)
        if m:
            found[int(m.group(1))] = p
    return dict(sorted(found.items()))


def snapshot(state) -> dict:
    """The whole train state as a ``torch.save`` payload on the host."""
    params, bn_state = P.to_numpy(state.model)
    names = {
        id(t): (name, leaf)
        for name, layer in P.layers(state.model).items()
        for leaf, t in layer.named_parameters(recurse=False)
    }
    momentum: dict = {}
    for t, slot in state.optimizer.state.items():
        buf = slot.get("momentum_buffer")
        if buf is not None:
            name, leaf = names[id(t)]
            momentum.setdefault(name, {})[leaf] = torch.from_numpy(P.to_jax_layout(leaf, buf))

    def tensors(tree):
        return {n: {l: torch.from_numpy(a) for l, a in d.items()} for n, d in tree.items()}

    return {
        "arch": state.arch,
        "step": int(state.step),
        "params": tensors(params),
        "bn_state": tensors(bn_state),
        "momentum": momentum,
        "generator": state.generator.get_state(),
    }


def load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def apply(payload: dict, state):
    """Load a :func:`snapshot` payload into ``state`` in place and return it.

    Raises ValueError, before changing anything, on another stage's
    checkpoint or any layer, leaf or shape that does not match. The stage's
    frozen leaves stay frozen, and any serving fold of the old weights is
    dropped (``params.from_numpy``).
    """
    if payload["arch"] != state.arch:
        raise ValueError(f"a checkpoint of the {payload['arch']!r} stage, not {state.arch!r}")
    trainable = {
        (name, leaf): t
        for name, layer in P.layers(state.model).items()
        for leaf, t in layer.named_parameters(recurse=False)
        if t.requires_grad
    }
    momentum = {}
    for name, leaves in payload["momentum"].items():
        for leaf, arr in leaves.items():
            t = trainable.get((name, leaf))
            buf = P.to_torch_layout(leaf, arr.numpy())
            if t is None or buf.shape != t.shape:
                raise ValueError(f"momentum of {name}/{leaf} does not match the train state")
            momentum[t] = buf
    as_numpy = lambda tree: {n: {l: a.numpy() for l, a in d.items()} for n, d in tree.items()}
    P.from_numpy(state.model, as_numpy(payload["params"]), as_numpy(payload["bn_state"]))
    with torch.no_grad():  # in place: a captured step holds these buffers
        for t, slot in state.optimizer.state.items():
            buf = slot["momentum_buffer"]
            if t in momentum:
                buf.copy_(momentum[t])
            else:  # a leaf no step has reached yet
                buf.zero_()
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def _replace_into(directory: Path, name: str, write) -> Path:
    """write(tmp_path), then rename it to directory/name."""
    final = directory / name
    tmp = directory / f".{name}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, final)
    return final


class Checkpointer:
    def __init__(self, directory, *, max_to_keep: int = 5, keep_best: bool = True, mesh=None):
        self.dir = Path(directory).absolute()
        self.mesh = mesh
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_dir = self.dir / _BEST_SUBDIR if keep_best else None
        if self.best_dir is not None:
            self.best_dir.mkdir(exist_ok=True)
        self._best_seen = self._initial_best()

    def _initial_best(self) -> float:
        step = self.best_step()
        if step is None:
            return math.inf
        try:
            return float(json.loads((self.best_dir / f"step-{step}.json").read_text())["loss"])
        except (OSError, ValueError, KeyError):
            return math.inf

    def save(self, step: int, train_state, metric: float | None = None):
        """Save ``train_state`` at ``step``; if ``metric`` (the monitored
        loss) improves on the best seen, it also fills the best slot. A step
        at or before the newest saved one is not saved again (orbax's
        ``should_save``). Under a mesh rank 0 writes, and every rank returns
        once the save is complete."""
        if axis_rank(self.mesh) == 0:
            self._save(int(step), train_state, metric)
        group = axis_group(self.mesh)
        if group is not None:
            dist.barrier(group=group)

    def _save(self, step: int, train_state, metric: float | None):
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return
        payload = snapshot(train_state)
        name = f"step-{step}.pt"
        saved = _replace_into(self.dir, name, lambda p: torch.save(payload, p))
        for old in self.all_steps()[: -self.max_to_keep]:
            (self.dir / f"step-{old}.pt").unlink()
        if (
            self.best_dir is not None
            and metric is not None
            and math.isfinite(metric)
            and metric < self._best_seen
        ):
            self._best_seen = float(metric)
            # a second name for the same bytes where the filesystem allows it
            _replace_into(self.best_dir, name, lambda p: _link_or_copy(saved, p))
            _replace_into(
                self.best_dir, f"step-{step}.json",
                lambda p: p.write_text(json.dumps({"loss": float(metric)})),
            )
            for old in step_files(self.best_dir):
                if old != step:
                    (self.best_dir / f"step-{old}.pt").unlink()
                    (self.best_dir / f"step-{old}.json").unlink(missing_ok=True)

    def restore_latest(self, train_state):
        """Restore the newest save into ``train_state`` (in place), or None."""
        steps = step_files(self.dir)
        if not steps:
            return None
        return apply(load(steps[max(steps)]), train_state)

    def restore_best(self, train_state):
        """Restore the lowest-monitored-loss save, or None if no save ever
        carried a metric (None, not the newest: a caller that wants a
        fallback chain tries restore_latest itself)."""
        step = self.best_step()
        if step is None:
            return None
        return apply(load(self.best_dir / f"step-{step}.pt"), train_state)

    def best_step(self):
        if self.best_dir is None:
            return None
        steps = step_files(self.best_dir)
        return max(steps) if steps else None

    def wait(self):
        """Saves are synchronous: nothing is in flight when save returns."""

    def all_steps(self):
        return list(step_files(self.dir))


def _link_or_copy(src: Path, dst: Path):
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)
