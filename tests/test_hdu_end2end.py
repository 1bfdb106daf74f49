"""The benchmark's float32 reference of H-DenseUNet's end-to-end training
step (``hdu_bench/reference/train_hybrid.py``) against the port's
``train_step`` with ``arch`` end2end, at the benchmark's tiny widths on
batch 2 of 32x32x8 on the CPU, from the same seeded weights, batch and
dropout seed; then the cut cell ``hdu.train.end2end`` through
``run.execute``, sound and with its ``half_batch`` fault, in a process of
their own (a run refuses to report where JAX is loaded, as it is beside
the JAX package's tests). Tolerances are test_torch_train.py's for a
hybrid step."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hdenseunet_tpu_torch.core.config import Config
from hdenseunet_tpu_torch.models import layers as L
from hdenseunet_tpu_torch.train import loss as TL
from hdenseunet_tpu_torch.train import trainer as T
from hdenseunet_tpu_torch.train.optimizer import make_optimizer
from hdu_bench import run as RUN
from hdu_bench.reference import models as R
from hdu_bench.reference import train_hybrid as RH
from hdu_bench.tests import tiny
from hdu_bench.weights import make_weights
from test_torch_train import GRAD_MAX_RTOL, LOSS_RTOL, STAT_TOL

CELL = "hdu.train.end2end"
SEED = 21
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pool(cfg, n=1, seed=SEED):
    runner = RUN.load_module(RUN.HERE / "runners" / "train_hybrid.py", "train_hybrid_runner")
    tr = cfg["train"]
    return runner.pool({"pool": n, "intensity_sd": 60.0}, tr["batch_per_gpu"], tr["crop_size"],
                       tr["input_cols"], seed, "cpu", cfg["num_classes"])


def _program_state(cfg, w):
    tr = cfg["train"]
    c = Config()
    c.model.preset, c.model.input_size, c.model.input_cols = "tiny", tr["crop_size"], tr["input_cols"]
    c.train.arch, c.train.batch = "end2end", tr["batch_per_gpu"]
    model = T.build_model(c, "end2end", device="cpu")
    model.load_state_dict(w)
    opt, labels = make_optimizer(model, "end2end", tr["lr"], tr["momentum"], True)
    state = T.TrainState(model, opt, labels, "end2end", torch.Generator().manual_seed(SEED),
                         torch.tensor(tr["loss_weights"]))
    return c, state


@pytest.fixture(scope="module")
def step():
    """One step of the program and of the reference: the program's state
    after it, its loss and the head's dropout (x, seed); the reference's
    trainer, loss and gradients; the weights and the batch."""
    cfg = tiny.config("hdenseunet_end2end", "float32")
    cfg["train"].update(crop_size=32, batch_per_gpu=2)
    w = make_weights(cfg, SEED, "cpu")
    batch = _pool(cfg)[0]
    c, state = _program_state(cfg, w)
    seed = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(SEED)))
    drops = []
    inner = L.dropout

    def spy(x, rate, seed=None, **kw):
        drops.append((x.detach().clone(), rate, seed))
        return inner(x, rate, seed, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "dropout", spy)
        loss = float(T.train_step(state, batch, c))
    ref = RH.Trainer(w, cfg, R.Float32Ops())
    ref_loss, ref_grads = ref.step(batch["image"], batch["label"], seed)
    return dict(cfg=cfg, w=w, batch=batch, state=state, loss=loss, drops=drops, seed=seed,
                ref=ref, ref_loss=ref_loss, ref_grads=ref_grads)


def test_loss_matches(step):
    assert abs(step["loss"] - step["ref_loss"]) <= LOSS_RTOL * abs(step["ref_loss"])


def test_gradients_match(step):
    """Every trained leaf's gradient within the hybrid bar of its largest
    entry; the leaves the program does not reach (the 3D branch's own
    classifier) take none in either."""
    params = dict(step["state"].model.named_parameters())
    trained = {k for k, p in params.items() if p.requires_grad}
    assert trained == set(step["ref_grads"])
    for k in sorted(trained):
        want = step["ref_grads"][k]
        got = torch.zeros_like(want) if params[k].grad is None else params[k].grad
        tol = 1e-5 + GRAD_MAX_RTOL["end2end"] * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, k
    assert params["net3d.3dclassifer.kernel"].grad is None
    assert float(step["ref_grads"]["net3d.3dclassifer.kernel"].abs().max()) == 0.0


def test_frozen_2d_batch_norms_unchanged(step):
    """The 2D branch's BNs (their affine and moving statistics) take no
    gradient and do not move, in the program and in the reference."""
    model = step["state"].model
    frozen = [k for k in step["w"] if k.startswith("net2d.") and not RH.trains(k)]
    assert any(".moving_" in k for k in frozen) and any(k.endswith("_bn.gamma") for k in frozen)
    now = model.state_dict()
    for k in frozen:
        assert torch.equal(now[k], step["w"][k]), k
        assert torch.equal(step["ref"].params[k], step["w"][k]), k
        assert not step["ref"].params[k].requires_grad, k
    for k, p in model.named_parameters():
        if k in frozen:
            assert p.grad is None and not p.requires_grad, k


def test_moving_statistics_after_the_merge(step):
    """The live BNs' (3D branch and head) moving statistics after the step's
    0.99/0.01 merge."""
    now = step["state"].model.state_dict()
    live = [k for k in now if ".moving_" in k and not k.startswith("net2d.")]
    assert live
    for k in live:
        assert not torch.equal(now[k], step["w"][k]), k
        torch.testing.assert_close(now[k], step["ref"].params[k].detach(), **STAT_TOL)


def test_head_dropout_mask_bit_for_bit(step):
    """The program draws one mask a step, the head's, at 0.3; the reference
    states it from the step's seed alone."""
    assert len(step["drops"]) == 1
    x, rate, seed = step["drops"][0]
    assert rate == 0.3
    program = L.dropout(torch.ones_like(x), rate, seed) != 0
    want = RH.head_keep(step["seed"], tuple(x.shape), rate, "cpu") != 0
    assert torch.equal(program, want)
    assert 0.6 < float(want.float().mean()) < 0.8


def test_masked_loss_ignores_the_boundary_slices(step):
    """Labels at z 0 and D-1 change neither loss; the program's and the
    reference's agree on the same logits."""
    cfg = step["cfg"]
    label = step["batch"]["label"]
    d = label.shape[-1]
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((*label.shape, cfg["num_classes"]), generator=gen)  # (B, H, W, D, C)
    other = label.clone()
    other[..., 0] = (other[..., 0] + 1) % 3
    other[..., d - 1] = (other[..., d - 1] + 2) % 3
    weights = torch.tensor(cfg["train"]["loss_weights"])
    ref = [float(RH.masked_loss(logits.permute(0, 4, 1, 2, 3), lab, weights)) for lab in (label, other)]
    prog = [float(TL.weighted_crossentropy_hybrid(logits, lab, weights)) for lab in (label, other)]
    assert ref[0] == ref[1] and prog[0] == prog[1]
    assert abs(prog[0] - ref[0]) <= LOSS_RTOL * abs(ref[0])
    inner = label.clone()
    inner[..., 1] = (inner[..., 1] + 1) % 3
    assert float(RH.masked_loss(logits.permute(0, 4, 1, 2, 3), inner, weights)) != ref[0]


RUNS = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(2)
from hdu_bench import run as RUN
from hdu_bench.tests import tiny
cell = RUN.load_json("workloads", sys.argv[2])
cfg = tiny.config(cell["config"], "float32")
cfg["train"].update(crop_size=32, batch_per_gpu=4)
for fault in (None, "half_batch"):
    res = RUN.execute(sys.argv[2], cell, cfg, tiny.traffic(cell["traffic"]), "cpu", seed=int(sys.argv[3]),
                      seconds=0.2, trace=0, fault=fault)
    print("RESULT " + json.dumps(res), flush=True)
"""


@pytest.fixture(scope="module")
def runs():
    """The cut cell, cut further to batch 4 of 32x32x8, through
    ``run.execute`` in float32 on the CPU in a fresh interpreter, sound and
    with ``half_batch``: [(result, the first gradient's median-leaf gap,
    which the runner prints where the cell's limits do not compare it)]."""
    out = subprocess.run([sys.executable, "-c", RUNS, str(ROOT), CELL, str(SEED)], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    results = [json.loads(line[len("RESULT "):]) for line in out.stdout.splitlines()
               if line.startswith("RESULT ")]
    gaps = [float(g) for g in re.findall(r"not compared: grad_gap (\S+)", out.stderr)]
    assert len(results) == len(gaps) == 2, out.stderr[-3000:]
    return list(zip(results, gaps))


def test_cut_cell_is_correct(runs):
    res, _ = runs[0]
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_ms_per_step.graphed"]["value"] > 0.0
    assert set(res["checks"]) == {"update_gap", "grad_gap_3d", "update_gap_3d"}


def test_half_batch_fault_is_caught(runs):
    """The loss over half the batch: the first gradient's median leaf reads
    far over the sound program's, and the 3D branch's and head's first
    gradient fails the cell's limit."""
    (_, sound), (res, grad_gap) = runs
    assert grad_gap > 100 * sound
    assert not res["correct"], res["checks"]
    check = res["checks"]["grad_gap_3d"]
    assert check["value"] > check["limit"], res["checks"]
