"""The cut cells on the card: a sound float32 run is correct and the
float8 control is not, with the cells' own limits. Each test skips without
a card; the fixture decides, never the module's import."""
from __future__ import annotations

import pytest
import torch

from hdu_bench.tests import tiny

CELLS = ["hdu.serve.devpp", "d167.train.graphed", "d167.train.eager"]


@pytest.fixture
def cuda():
    """The card, with TF32 off, so that the program's float32 is float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(cuda, cell):
    res = tiny.execute(cell, precision="float32", seed=12, device=cuda)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["d167.train.graphed", "d167.train.eager"])
def test_control_on_the_card(cuda, cell):
    """The train cells' control; the cut served network gives a seed's
    volume on the card no label to flip (the CPU test covers serving)."""
    res = tiny.execute(cell, precision="float32", seed=12, device=cuda, control=True)
    assert not res["correct"], res["checks"]
