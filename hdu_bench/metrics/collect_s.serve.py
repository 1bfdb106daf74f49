"""Host seconds a served volume spends in ``VolumePredictor.collect`` (the
wait on the fetch, and the host CC postprocess where it runs), over the
window's volumes."""
from hdu_bench import readers

UNIT = "s/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return readers.per_unit(run, MOVES, "collect")
