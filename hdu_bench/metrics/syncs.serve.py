"""Host-blocking CUDA synchronisations a served volume makes inside the
program's spans (pageable uploads, the fetch), over the traced volumes."""
from hdu_bench import recorder

UNIT = "syncs/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.syncs_per_unit(run, MOVES)
