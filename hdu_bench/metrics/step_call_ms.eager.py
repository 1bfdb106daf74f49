"""Host milliseconds inside the program's step call (``train_step``, or a
``MultiStep`` call over its K steps) per optimizer step of the window."""
from hdu_bench import readers

UNIT = "ms/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return readers.per_unit(run, MOVES, "step_call", 1e3)
