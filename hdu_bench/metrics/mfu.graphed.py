"""3 x the 2D network's forward FLOPs at the cell's batch
(``work/counts.train_step``) over the window's wall seconds per step, as a
share of the card's dense bfloat16 peak."""
from hdu_bench import readers

UNIT = "%"
MOVES = "train_ms_per_step.graphed"


def read(run):
    return readers.mfu(run, MOVES, 1e-3)
