"""Data parallelism over ``torch.distributed`` (counterpart of
hdenseunet_tpu/parallel/__init__.py).

* data parallelism: one process per card, the global batch split into one
  row block per rank over the 'data' mesh, parameters replicated, the
  gradients, BatchNorm's live statistics and the loss sums reduced over the
  global batch — the reference's in-graph GPU tower replication
  (Keras-2.0.8/keras/utils2/multi_gpu.py) as separate processes;
* inference window parallelism: each rank scores its share of every batch
  of sliding windows, and one all-reduce per volume sums the scores
  (``infer/device_pipeline.py``; the host loop reduces each batch's
  probabilities, ``infer/sliding_window.py``);
* multi-process: :mod:`.multihost` joins the process group (torchrun's
  environment) and feeds each process its LOCAL rows of the batch.
"""
from ..core.mesh import (  # noqa: F401
    DATA_AXIS,
    batch_sharding,
    check_batch_divisible,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .multihost import (  # noqa: F401
    global_batch_from_local,
    initialize,
    is_primary,
    local_batch_size,
    put_batch,
)
