"""The 'data' mesh and the batch helpers (counterpart of
hdenseunet_tpu/core/mesh.py).

Data parallelism in the port is one process per card. The JAX package's 1-D
``Mesh`` over the devices becomes a 1-D ``DeviceMesh`` named 'data' over the
process group's ranks; the global batch is split into equal row blocks, one
per rank (rank r holds rows [r*n, (r+1)*n)), parameters are replicated, and
the code that needs a reduction over the global batch issues it on the
mesh's process group: BatchNorm's live statistics (``ops/bn_live.py``),
the loss sums of K2 (``ops/wce.py``), the gradients (``train/trainer.py``)
and the window scores (``infer/``). Only ``all_reduce``, ``broadcast`` and
``barrier`` are used, so the same code runs over NCCL on cards and over gloo
on the CPU, or with several ranks on one card.

A process that joined no process group gets a :class:`LocalMesh` of one
rank, which issues no collective, so every call site works unchanged in a
single process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"


class LocalMesh:
    """The one-rank 'data' mesh of a process outside any process group: the
    part of ``DeviceMesh``'s interface the port reads, with no group."""

    def __init__(self, device_type: str = "cuda", axis_name: str = DATA_AXIS):
        self.device_type = device_type
        self.mesh_dim_names = (axis_name,)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None

    def __repr__(self):
        return f"LocalMesh({self.device_type!r}, {self.mesh_dim_names})"


def make_mesh(device=None, axis_name: str = DATA_AXIS):
    """1-D data-parallel mesh over every rank of the process group, or a
    :class:`LocalMesh` when this process joined none. ``device`` gives the
    mesh's device type (default: the group's, 'cuda' under NCCL and 'cpu'
    under gloo; without a group 'cuda', which raises when there is no card:
    a CPU mesh is asked for with ``device='cpu'``)."""
    if device is not None:
        device_type = torch.device(device).type
    elif dist.is_initialized():
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    elif torch.cuda.is_available():
        device_type = "cuda"
    else:
        raise RuntimeError("make_mesh: no CUDA card; pass device='cpu' for a CPU mesh")
    if not dist.is_initialized():
        return LocalMesh(device_type, axis_name)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(dist.get_world_size()), mesh_dim_names=(axis_name,))


def axis_size(mesh) -> int:
    """Ranks on the mesh's 'data' axis; 1 for ``None``."""
    return 1 if mesh is None else mesh.size()


def axis_rank(mesh) -> int:
    """This process's index on the 'data' axis; 0 for ``None``."""
    return 0 if mesh is None else mesh.get_local_rank()


def axis_group(mesh):
    """The process group of the 'data' axis, or None (no mesh, or a
    :class:`LocalMesh`): where it is None, no collective is issued."""
    return None if mesh is None else mesh.get_group()


def batch_sharding(mesh):
    """DTensor placements of a batch split along its leading axis over the
    mesh (JAX ``NamedSharding(mesh, P('data'))``)."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh):
    """DTensor placements of a replicated value (JAX ``P()``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global host batch: block ``axis_rank(mesh)`` of
    ``axis_size(mesh)`` equal blocks of every array's leading axis."""
    n, r = axis_size(mesh), axis_rank(mesh)
    out = {}
    for k, v in batch.items():
        check_batch_divisible(len(v), mesh)
        rows = len(v) // n
        out[k] = v[r * rows : (r + 1) * rows]
    return out


@torch.no_grad()
def _through_flat(tensors, collective):
    """Run ``collective`` in place on one flat buffer per dtype of
    ``tensors``, then copy the result back into each tensor."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        collective(flat)
        offset = 0
        for t in same:
            t.copy_(flat[offset : offset + t.numel()].view(t.shape))
            offset += t.numel()


def replicate(mesh, module_or_tensors):
    """Broadcast from the mesh's rank 0, in place: every parameter and
    buffer of a module, or each tensor of a sequence (one broadcast per
    dtype, through a flat buffer). Returns the argument."""
    group = axis_group(mesh)
    if group is None:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    src = dist.get_global_rank(group, 0)
    _through_flat(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))
    return module_or_tensors


def all_reduce_(tensors, group):
    """Sum each tensor over the ranks of ``group``, in place: one all-reduce
    per dtype, through a flat buffer (the gradient bucket of a step)."""
    _through_flat(list(tensors), lambda flat: dist.all_reduce(flat, group=group))


def check_batch_divisible(global_batch: int, mesh, axis_name: str = DATA_AXIS):
    n = axis_size(mesh)
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh axis "
            f"'{axis_name}' size {n}"
        )
