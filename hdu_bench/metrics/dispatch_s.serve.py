"""Host seconds a served volume spends in ``VolumePredictor.dispatch`` (the
mask extent, the upload and the queueing of the scoring), over the window's
volumes."""
from hdu_bench import readers

UNIT = "s/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return readers.per_unit(run, MOVES, "dispatch")
