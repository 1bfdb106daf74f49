"""The convolution FLOPs of the distinct work one volume needs
(``work/counts.serve_volume``) over the window's wall seconds per volume,
as a share of the card's dense bfloat16 peak."""
from hdu_bench import readers

UNIT = "%"
MOVES = "serve_s_per_volume"


def read(run):
    return readers.mfu(run, MOVES, 1.0)
