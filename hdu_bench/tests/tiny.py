"""The benchmark's cells cut to a size the CPU tests can run: the program's
'tiny' preset widths in the configuration, small volumes, crops and pools.
The cells' own limits are kept."""
from __future__ import annotations

import copy

from hdu_bench import run as RUN


def config(name: str, precision: str | None = None) -> dict:
    cfg = copy.deepcopy(RUN.load_json("configs", name))
    cfg["port_preset"] = "tiny"
    cfg["net2d"].update(blocks=[2, 2, 2, 2], growth=8, decoder_widths=[32, 32, 16, 16, 16])
    if "net3d" in cfg:
        cfg["net3d"].update(blocks=[1, 1, 2, 2], growth=8, decoder_widths=[16, 16, 16, 16, 16])
        cfg["infer"]["input_size"] = 64
    if "train" in cfg:
        cfg["train"].update(crop_size=64, batch_per_gpu=4)
    if precision is not None:
        cfg["precision"] = precision
    return cfg


def traffic(name: str, program: dict | None = None) -> dict:
    """The cut traffic; ``program`` replaces settings of a serving mix's
    predictor (``{"device_postprocess": False}`` serves with the host
    postprocess)."""
    tr = copy.deepcopy(RUN.load_json("traffic", name))
    if tr["runner"] == "serve":
        tr.update(shape=[64, 64, 24], liver_z=[6, 18], xy_margin=8, pool=2, trace_volumes=2)
        tr["program"].update(program or {})
    else:
        tr.update(pool=8, trace_calls=2)
        if tr["steps_per_dispatch"] > 1:
            tr["steps_per_dispatch"] = 4
        if "dataset" in tr:
            tr["dataset"] = {"volumes": 2, "shape": [80, 80, 16]}
    return tr


def execute(cell_name: str, *, precision=None, program=None, seed=1234567890123, seconds=0.5,
            trace=0, device="cpu", **kw):
    """One run of the cut cell on ``device``; returns its result dict."""
    cell = RUN.load_json("workloads", cell_name)
    return RUN.execute(cell_name, cell, config(cell["config"], precision),
                       traffic(cell["traffic"], program), device, seed=seed, seconds=seconds,
                       trace=trace, **kw)
