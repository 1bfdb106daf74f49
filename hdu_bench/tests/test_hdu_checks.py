"""The correctness checks against planted faults and the control, at the
cut size on the CPU: the harness's look for a card is skipped and the rest
of a run is driven with the cells' own limits. The program runs in float32
here, where a sound run reads at rounding; a fault has to bring ``correct``
out false. The serving cell runs with its device postprocess and with the
host's, the predictor's shipped default."""
from __future__ import annotations

import pytest

from hdu_bench.tests import tiny

HOST = {"device_postprocess": False}
SERVE = [("hdu.serve.devpp", None), ("hdu.serve.devpp", HOST)]
TRAIN = [("d167.train.graphed", None), ("d167.train.eager", None)]
IDS = ["devpp", "host_postprocess", "graphed", "eager"]


@pytest.mark.parametrize("cell,program", SERVE + TRAIN, ids=IDS)
def test_a_sound_run_is_correct(cell, program):
    res = tiny.execute(cell, precision="float32", program=program, seed=12)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,program,fault",
                         [(c, p, f) for c, p in SERVE for f in ("answer_altered", "half_batch")]
                         + [(c, p, f) for c, p in TRAIN for f in ("state_unchanged", "half_batch")])
def test_a_fault_is_caught(cell, program, fault):
    res = tiny.execute(cell, precision="float32", program=program, seed=12, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,program", SERVE + TRAIN, ids=IDS)
def test_the_control_is_not_correct(cell, program):
    """The reference in float8 in the program's place fails the limits."""
    res = tiny.execute(cell, program=program, seed=12, control=True)
    assert not res["correct"], res["checks"]
