"""Host→device input pipeline: background prefetch + side-stream h2d copies.

Counterpart of hdenseunet_tpu/data/pipeline.py, the replacement for the
reference's GeneratorEnqueuer (Keras-2.0.8/keras/utils/data_utils.py:530,
workers=3, max_queue_size=10 at train_2ddense.py:209-210):

* :class:`PrefetchIterator` — one background thread producing numpy
  batches into a bounded queue; the sampler's hot calls release the GIL;
* :func:`device_prefetch` — each batch pinned and copied to the card on a
  side CUDA stream, ``depth`` batches ahead of the step that reads it, so
  the host→HBM copy overlaps the previous step's compute.

The consumer's waits on the queue and its pin-and-copy are the program's
spans ``feed_queue`` and ``feed_put`` (``utils.profiling``); the producer
thread records nothing.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..utils.profiling import annotate


class PrefetchIterator:
    """Wrap a batch iterator with a bounded background-thread prefetch queue.

    The producer's exception is raised on the consumer side, after the
    batches it produced before it."""

    _SENTINEL = object()

    def __init__(self, source, depth: int = 4):
        self.source = source
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        with annotate("feed_queue"):
            item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(item)  # every later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0):
        """Stop the producer: drain the queue until its thread has ended
        (it finishes the batch it is making first), then close the source,
        which shuts a sampler's crop pool down."""
        self._stop.set()
        end = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < end:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        if not self._thread.is_alive() and hasattr(self.source, "close"):
            self.source.close()


def _host_tensors(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(torch.int32) if k == "label" else t
    return out


def device_prefetch(batch_iterator, device, *, depth: int = 2):
    """Yield batches as tensors on ``device``, copied ``depth`` batches ahead.

    On a card each batch is pinned and copied on a side stream; the stream
    that takes a batch waits on its copy's event, and every tensor is marked
    as used by that stream (``record_stream``), so the caching allocator
    does not hand its memory out again while a step may still read it. On
    the CPU the batches pass through as they are.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iterator:  # not `yield from`, which would close the source
            yield batch
        return
    copy_stream = torch.cuda.Stream(device)
    buf: deque = deque()

    def ready(tensors, event):
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in tensors.values():
            t.record_stream(compute)
        return tensors

    for batch in batch_iterator:
        with annotate("feed_put"):
            host = {k: t.pin_memory() for k, t in _host_tensors(batch).items()}
            with torch.cuda.stream(copy_stream):
                tensors = {k: t.to(device, non_blocking=True) for k, t in host.items()}
                event = torch.cuda.Event()
                event.record(copy_stream)
        buf.append((tensors, event))
        if len(buf) >= depth:
            yield ready(*buf.popleft())
    while buf:
        yield ready(*buf.popleft())


def input_pipeline(sampler, batch: int, device, *, host_depth=4, device_depth=2, threads=None):
    """sampler.batches() -> threaded host prefetch -> device prefetch.

    ``batch`` is what this process feeds: under data parallelism its rows of
    the global batch (``parallel.multihost.local_batch_size``), to its own
    card ``device``. ``threads`` (default: the sampler config's
    ``crop_threads``) fans the
    per-sample crop work over a pool inside the producer. Returns
    ``(batches, host)``: close ``host`` when done with the batches.
    """
    if threads is None:
        threads = getattr(getattr(sampler, "cfg", None), "crop_threads", 1)
    host = PrefetchIterator(sampler.batches(batch, threads=threads), depth=host_depth)
    return device_prefetch(host, device, depth=device_depth), host
