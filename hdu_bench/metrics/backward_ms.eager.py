"""Host milliseconds a step spends in the program's ``backward`` span
(``loss.backward()``, which replays the forward under remat), over the
traced steps."""
from hdu_bench import recorder

UNIT = "ms/step"
MOVES = "train_ms_per_step.eager"


def read(run):
    return recorder.span_per_unit(run, MOVES, "backward", 1e3)
