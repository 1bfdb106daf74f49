"""Share of the traced training window in which no kernel, copy or memset
ran on the card (the profiler's device timeline)."""
from hdu_bench import readers

UNIT = "%"
MOVES = "train_ms_per_step.graphed"


def read(run):
    return readers.idle_pct(run, MOVES)
