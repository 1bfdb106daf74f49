"""Window batches the scorer runs a served volume (its live batches: the
gathers, the forward and K3a), from the program's counter
``window_batches``, over the traced volumes."""
from hdu_bench import recorder

UNIT = "batches/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.count_per_unit(run, MOVES, "window_batches")
