"""Share of the traced serving window in which no kernel, copy or memset
ran on the card (the profiler's device timeline)."""
from hdu_bench import readers

UNIT = "%"
MOVES = "serve_s_per_volume"


def read(run):
    return readers.idle_pct(run, MOVES)
