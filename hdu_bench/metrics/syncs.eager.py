"""Host-blocking CUDA synchronisations a step makes inside the program's
spans, over the traced steps."""
from hdu_bench import recorder

UNIT = "syncs/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return recorder.syncs_per_unit(run, MOVES)
