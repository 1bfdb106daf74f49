"""Failure detection for long training runs (counterpart of
hdenseunet_tpu/utils/guards.py, :class:`NaNGuard` only).

The reference has none: ``TerminateOnNaN`` exists unused
(Keras-2.0.8/keras/callbacks.py:230). :class:`NaNGuard` inspects the
host-fetched loss stream and raises after the first non-finite loss with
recent-history context.
"""
from __future__ import annotations

import math


class NaNGuard:
    def __init__(self, history: int = 20):
        self.history = history
        self._recent: list[float] = []

    def check(self, loss: float, step: int) -> None:
        v = float(loss)
        if math.isfinite(v):
            self._recent.append(v)
            if len(self._recent) > self.history:
                self._recent.pop(0)
            return
        ctx = ", ".join(f"{x:.4f}" for x in self._recent[-5:])
        raise FloatingPointError(
            f"non-finite loss {v} at step {step}; last finite losses: [{ctx}]. "
            f"Resume from the latest checkpoint with a lower LR."
        )
