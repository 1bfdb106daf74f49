"""Voxels of the external mask's grown bounding box that the program's mask
extent dilates a served volume (``postprocess.liver_mask_extent``), from the
program's counter ``mask_box_voxels``, over the traced volumes."""
from hdu_bench import recorder

UNIT = "voxels/volume"
MOVES = "serve_s_per_volume"


def read(run):
    return recorder.count_per_unit(run, MOVES, "mask_box_voxels")
