"""Host milliseconds a step spends in the program's ``forward`` span (the
2D network's forward and the loss queued), over the traced steps."""
from hdu_bench import recorder

UNIT = "ms/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return recorder.span_per_unit(run, MOVES, "forward", 1e3)
