"""Host seconds a served volume spends in the program's ``scoring`` span
(the upload, the window batches and the compose queued, and the syncs
among them), over the traced volumes."""
from hdu_bench import recorder

UNIT = "s/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.span_per_unit(run, MOVES, "scoring")
