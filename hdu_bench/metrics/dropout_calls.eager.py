"""Dropout calls a training step makes through K7 (``ops/dropout.py``; a
checkpoint's recompute counts again), from the program's counter
``dropout``, over the traced eager steps; None where the program keeps no
such counter."""
from hdu_bench import recorder

UNIT = "calls/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return recorder.count_per_unit(run, MOVES, "dropout")
