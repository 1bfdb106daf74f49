"""The multi-process runtime (counterpart of
hdenseunet_tpu/parallel/multihost.py).

One process per card, as ``torchrun`` starts them:

* :func:`initialize` joins the ``torch.distributed`` process group from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) or from its arguments; a plain
  invocation, with nothing configured, is a no-op returning False, so every
  entry point can call it unconditionally. A configured environment that
  cannot be joined raises: there is no quiet fall back to one process;
* :func:`local_batch_size` splits the global batch across processes, and
  each process feeds only its own rows (:func:`put_batch` places them on
  the rank's card, :func:`local_device`);
* :func:`is_primary` picks the process that owns console output and files.

The backend is NCCL for a rank on a card and gloo, asked for by name, on
the CPU. The port issues only ``all_reduce``, ``broadcast`` and
``barrier``, which gloo also runs on CUDA tensors: several ranks can share
one card over gloo, which NCCL refuses (tests/test_torch_dp_*.py,
chip_smoke.py).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import batch_sharding
from ..utils import profiling

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group; returns True when multi-process.

    Arguments fall back to ``WORLD_SIZE`` / ``RANK``, and the rendezvous to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); ``init_method`` may also
    be a ``file://`` or ``tcp://`` address. ``backend`` defaults to NCCL (the
    rank's card, :func:`local_device`, becomes the current device first);
    without a card that default raises, as :func:`core.mesh.make_mesh`
    does: a CPU group is asked for with ``backend='gloo'``. ``timeout``
    bounds the rendezvous and every collective. Nothing configured: a no-op
    returning False. Already joined: returns whether the group has several
    ranks."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size is None and rank is None:
        return False
    if world_size is None or rank is None:
        raise ValueError(
            f"a process group needs both a world size and a rank, got {world_size} and {rank}"
        )
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA card; pass backend='gloo' for a CPU group")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=timeout,
    )
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that should own logging/console output."""
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` (``cuda:0`` without torchrun)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def local_batch_size(global_batch: int) -> int:
    """Per-process share of the GLOBAL batch (validated)."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}"
        )
    return global_batch // n


def global_batch_from_local(mesh, local_batch: dict) -> dict:
    """This process's rows -> DTensors of the global batch, split along the
    leading axis over ``mesh`` (JAX ``make_array_from_process_local_data``).
    No data moves: each rank keeps its own rows."""
    from torch.distributed.tensor import DTensor

    return {
        k: DTensor.from_local(torch.as_tensor(np.ascontiguousarray(v)), mesh, batch_sharding(mesh),
                              run_check=False)
        for k, v in local_batch.items()
    }


def put_batch(batch: dict, device) -> dict:
    """numpy batch (this process's rows) -> tensors on ``device``; labels
    become int32. Pinned and asynchronous to a card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "label":
            t = t.to(torch.int32)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class PinnedFeed:
    """Host batches of one shape -> the same device tensors on every call,
    through pinned host buffers made once and reused (:func:`put_batch`
    pins fresh host memory each call). A captured CUDA graph reads fixed
    device tensors, and this is how its inputs are fed: one pinned
    host-to-device copy per array and call (``train/trainer.py`` feeds a
    group of K batches so). Before a call overwrites the pinned
    buffers it waits for the last call's copies to finish, so the host runs
    at most one call ahead of the card. On the CPU the host buffers are the
    tensors returned."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.host: dict | None = None
        self.out: dict | None = None
        self._copied = None

    def put(self, batch) -> dict:
        """Copy ``batch`` (numpy arrays, labels made int32) into the device
        tensors and return them (the same tensors every call). ``batch``
        may also be a list of K such dicts, written straight into the
        slots of (K, ...) buffers, with no stacked copy on the host."""
        cuda = self.device.type == "cuda"
        parts = batch if isinstance(batch, list) else [batch]
        if self.host is None:
            first = parts[0]
            lead = (len(parts),) if isinstance(batch, list) else ()
            dtype = lambda k, v: torch.int32 if k == "label" else torch.from_numpy(np.asarray(v)).dtype
            self.host = {k: torch.empty(lead + np.shape(v), dtype=dtype(k, v), pin_memory=cuda)
                         for k, v in first.items()}
            self.out = ({k: torch.empty_like(t, device=self.device) for k, t in self.host.items()}
                        if cuda else self.host)
            self._copied = torch.cuda.Event() if cuda else None
        elif cuda:
            profiling.wait(self._copied)
        for k, host in self.host.items():
            slots = host if isinstance(batch, list) else [host]
            for slot, part in zip(slots, parts):
                slot.copy_(torch.from_numpy(np.ascontiguousarray(part[k])))
            if cuda:
                self.out[k].copy_(host, non_blocking=True)
        if cuda:
            self._copied.record()
        return self.out
