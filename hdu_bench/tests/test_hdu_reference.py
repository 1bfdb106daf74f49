"""The frozen reference against the program at the 'tiny' preset on the
CPU, both in float32, and the distinct-work count against the program's
own count."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from hdu_bench.reference import models as R
from hdu_bench.reference import serve as S
from hdu_bench.reference.train import Trainer
from hdu_bench.tests import tiny
from hdu_bench import traffic
from hdu_bench.weights import make_weights
from hdu_bench.work import counts

PROB_TOL = 1e-4  # float32 against float32: summation order only
LOSS_TOL = 1e-5
STEP_TOL = 1e-3  # of the largest reference change of a leaf


@pytest.fixture(scope="module")
def served():
    """Program and reference on the tiny hybrid: probabilities, labelmaps,
    and the pieces both were made from."""
    from hdenseunet_tpu_torch.core.config import Config, InferConfig
    from hdenseunet_tpu_torch.infer import postprocess
    from hdenseunet_tpu_torch.infer.device_pipeline import DeviceVolumeScorer
    from hdenseunet_tpu_torch.infer.predictor import VolumePredictor
    from hdenseunet_tpu_torch.models.hybrid import HDenseUNet

    cfg = tiny.config("hdenseunet", "float32")
    tr = tiny.traffic("closed1.z192.devpp")
    w = make_weights(cfg, 12, "cpu")
    vol, mask = traffic.serve_pool(tr, 12, "cpu")[0]

    def model():
        m = HDenseUNet(preset="tiny", device="cpu")
        m.load_state_dict(w)
        return m

    infer = InferConfig(**cfg["infer"])
    scorer = DeviceVolumeScorer(model(), infer, compute_dtype="float32", device="cpu")
    dil, lo, hi = postprocess.liver_mask_extent(mask)
    probs = scorer.score(vol.astype(np.float32) - infer.mean, lo, hi).numpy()
    c = Config()
    c.model.preset, c.infer = "tiny", infer
    labels = VolumePredictor(model(), c, device="cpu").segment(vol, mask)
    ref_probs, ext = S.probabilities(R.Float32Ops(), vol, mask, w, cfg, "cpu")
    return dict(cfg=cfg, vol=vol, mask=mask, probs=probs, labels=labels, ref_probs=ref_probs,
                ref_labels=S.postprocess_raw(S.raw_labels(ref_probs, cfg["infer"]), ext), scorer=scorer, lo=lo, hi=hi)


def test_probabilities_within_tolerance(served):
    assert served["ref_probs"].shape == served["probs"].shape
    assert float(np.abs(served["ref_probs"] - served["probs"]).max()) <= PROB_TOL
    assert served["ref_probs"][..., 1].max() > 0.0  # a scored, non-trivial volume


def test_labelmaps_equal_away_from_thresholds(served):
    infer = served["cfg"]["infer"]
    differ = served["labels"] != served["ref_labels"]
    p = served["ref_probs"]
    near = (np.abs(p[..., 1] - infer["thres_liver"]) < PROB_TOL) | (
        np.abs(p[..., 2] - infer["thres_tumor"]) < PROB_TOL)
    assert not np.any(differ & ~near)
    assert np.any(served["ref_labels"] > 0)


def test_distinct_work_under_the_programs_count(served):
    shape = served["vol"].shape
    _, lo, hi = S.liver_extent(served["mask"])
    mine = counts.serve_volume(served["cfg"], shape, (lo, hi), counts.PEAKS["NVIDIA H100 80GB HBM3"])
    theirs = served["scorer"].estimate_flops(shape, served["lo"], served["hi"])
    assert 0.0 < mine["flops"] <= theirs
    assert mine["k5_bound_s"] > 0.0 and mine["windows"] > 0 and mine["stacks"] > mine["windows"]


def test_one_training_step_within_tolerance():
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.train import trainer
    from hdenseunet_tpu_torch.train.optimizer import make_optimizer

    cfg = tiny.config("denseunet167_2d", "float32")
    tr = cfg["train"]
    w = make_weights(cfg, 7, "cpu")
    b = traffic.train_pool({"pool": 1, "intensity_sd": 60.0}, tr["batch_per_gpu"], tr["crop_size"], 7, "cpu", 3)[0]
    c = Config()
    c.model.preset, c.model.input_size, c.train.arch = "tiny", tr["crop_size"], "2d"
    model = trainer.build_model(c, "2d", device="cpu")
    model.load_state_dict(w)
    opt, labels = make_optimizer(model, "2d", tr["lr"], tr["momentum"], True)
    gen = torch.Generator().manual_seed(99)
    state = trainer.TrainState(model, opt, labels, "2d", gen, torch.tensor(tr["loss_weights"]))
    loss = float(trainer.train_step(state, b, c))
    seed = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(99)))
    ref = Trainer(w, cfg, R.Float32Ops())
    ref_loss, _ = ref.step(b["image"], b["label"], seed)
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss)
    for k, p in model.named_parameters():
        d_prog, d_ref = p.detach() - w[k], ref.params[k].detach() - w[k]
        # a change is read off parameters of ~0.1: their float32 rounding is its floor
        floor = 4 * torch.finfo(torch.float32).eps * float(w[k].abs().max())
        assert float((d_prog - d_ref).abs().max()) <= STEP_TOL * float(d_ref.abs().max()) + floor, k
