"""Host milliseconds the training loop waits for its next batch from the
program's feed (``input_pipeline`` over ``CropSampler``) per step of the
window."""
from hdu_bench import readers

UNIT = "ms/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return readers.per_unit(run, MOVES, "feed_wait", 1e3)
