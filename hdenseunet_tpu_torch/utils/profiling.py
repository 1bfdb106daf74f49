"""Tracing (counterpart of hdenseunet_tpu/utils/profiling.py).

* :func:`trace`: ``torch.profiler`` over a block, written as a
  Chrome/Perfetto JSON trace (host operators and, on the card, its kernels
  and copies);
* :func:`annotate`: the program's span, a named host phase such as the
  mask extent, a window batch or a step's backward;
* :func:`count`: a counter of the program's units of work (the scorer's
  window batches and 2D slice stacks);
* :func:`wait`: an explicit wait on a CUDA event, counted as a sync;
* :func:`snapshot` and :func:`reset`: what the spans and counters have
  recorded.

Spans and counters record only while a ``torch.profiler`` session is open,
:func:`trace` or any other: with none open, a span costs one read of the
profiler's module flag and returns a shared empty context. While on, a span
is also a ``record_function`` scope of its name, on the profiler's
timeline beside the kernels, and keeps per name its count, its host
seconds and its self seconds (those its child spans on the same thread do
not cover). Each thread has its own stack of spans. While any span is open
on the card, c10's sync debug mode reports every host-blocking stream
synchronisation (a pageable upload, ``.cpu()``, ``.item()``) as a warning,
which is caught unprinted and counted as a sync of the innermost span open
on the warning's thread; event waits go through :func:`wait`. The
process's warning filters and sync debug mode are restored once the last
span closes.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"  # c10's warn_or_error_on_sync
MODE_WARNING = "Synchronization debug mode is a prototype feature"  # on setting the mode

_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans, innermost last
_spans: dict = {}  # name -> [count, total_s, self_s, syncs]
_counts: dict = defaultdict(int)
_open = 0  # spans open over all threads
_watch = None  # (catch_warnings, saved sync debug mode) while _open > 0
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """Profile the enclosed block into ``logdir`` (created if missing) as
    ``<host>_<pid>.<ns>.pt.trace.json``. CUDA and host activity on the
    card; host activity alone when ``device`` is the CPU. Yields the
    ``torch.profiler.profile``, readable (``events()``,
    ``key_averages()``) once the block has closed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))
    ) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)


def annotate(name: str, args: str | None = None):
    """The program's span ``name`` over a ``with`` block; ``args`` (a
    request's sequence number) goes on the profiler scope."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is open."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] += n


def wait(event) -> None:
    """``event.synchronize()``, counted as a sync of the innermost open
    span (c10's sync debug mode does not see ``cudaEventSynchronize``)."""
    event.synchronize()
    if _profiler._is_profiler_enabled:
        _synced()


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s", "syncs"}},
    "counts": {name: n}}`` since the process started or the last
    :func:`reset`."""
    with _lock:
        return {
            "spans": {name: dict(count=c, total_s=t, self_s=s, syncs=y)
                      for name, (c, t, s, y) in _spans.items()},
            "counts": dict(_counts),
        }


def reset() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _entry(name: str) -> list:
    """The span's record (the caller holds ``_lock``)."""
    rec = _spans.get(name)
    if rec is None:
        rec = _spans[name] = [0, 0.0, 0.0, 0]
    return rec


def _synced() -> None:
    stack = _stack()
    if stack:
        with _lock:
            _entry(stack[-1].name)[3] += 1


def _show(shown):
    """A ``warnings.showwarning`` that counts c10's sync warnings and hands
    every other warning to ``shown``."""

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            _synced()
        else:
            shown(message, category, filename, lineno, file, line)

    return show


def _opened() -> None:
    global _open, _watch
    with _lock:
        _open += 1
        if _open > 1:
            return
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message=MODE_WARNING)
        warnings.showwarning = _show(warnings.showwarning)
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _watch = (caught, mode)


def _closed() -> None:
    global _open, _watch
    with _lock:
        _open -= 1
        if _open:
            return
        caught, mode = _watch
        _watch = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)


class _Span:
    """One open span (see the module docstring)."""

    __slots__ = ("name", "args", "scope", "t0", "child")

    def __init__(self, name: str, args: str | None):
        self.name, self.args, self.child = name, args, 0.0

    def __enter__(self):
        self.scope = torch.profiler.record_function(self.name, self.args)
        self.scope.__enter__()
        _opened()
        _stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child += seconds
        with _lock:
            rec = _entry(self.name)
            rec[0] += 1
            rec[1] += seconds
            rec[2] += seconds - self.child
        _closed()
        self.scope.__exit__(*exc)
        return False
