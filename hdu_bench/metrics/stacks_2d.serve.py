"""Slice stacks the scorer's dedup path runs through the 2D network a
served volume, from the program's counter ``stacks_2d``, over the traced
volumes."""
from hdu_bench import recorder

UNIT = "stacks/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.count_per_unit(run, MOVES, "stacks_2d")
