"""Host seconds a served volume spends in the program's ``mask_extent``
span (``postprocess.liver_mask_extent``: the external mask's dilation and
its liver box), over the traced volumes."""
from hdu_bench import recorder

UNIT = "s/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.span_per_unit(run, MOVES, "mask_extent")
