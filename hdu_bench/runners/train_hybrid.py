"""Train runner of H-DenseUNet's end-to-end stage: optimizer steps of
``arch`` end2end through the program's ``trainer.make_multi_step`` (K
steps a call, captured as a CUDA graph from its second call on the card),
held to the float32 reference of the stage (``reference/train_hybrid.py``).

The protocol is ``runners/train.py``'s, loaded as a private copy of that
module whose state builder and reference trainer are this stage's: set-up
makes the weights from the seed and hands them to the program's hybrid
through its state dict; the first call's steps run eagerly, the second is
captured and replayed; the window runs calls until ``seconds`` have passed
and ends in a device synchronisation. The batches are a pool on the device
(:func:`pool`): ``pool`` batches of ``batch`` volumes of crop x crop x
depth, ``normal(0, intensity_sd)`` rounded to whole HU, with labels drawn
uniformly from the classes.

``correct``: the numbers of ``runners/train.py`` (``grad_gap``,
``update_gap``, ``conv_update_gap``, ``conv_worst_gap``, over every
trained leaf; the convolution kernels are the 2D and 3D branches' and the
head's), from the first call's first three steps and the second call's
replayed steps; and the same numbers over the leaves of the 3D branch and
the head alone, suffixed ``_3d`` (with ``conv_grad_gap_3d``, the median
kernel's gap of the first gradient). The 2D branch's frozen BatchNorms
leave its Scales' gradients at bfloat16's rounding of a sum that cancels,
so on some seeds the 2D leaves of a sound program read like the float8
control (PERF.md); the 3D branch's live BatchNorms couple the batch, so a
fault in the batch shows there most. ``--fault half_batch`` is planted
here, on the hybrid's loss (``trainer.weighted_crossentropy_hybrid``, the
first half of the batch alone); the harness's ``state_unchanged`` sets the
learning rate to 0.

``work``: ``flops`` (``work/train_hybrid.train_step``), the card's
``peaks`` and ``k1_bound_s`` (``work/train_hybrid.k1_bound_s``, at the
step's batch x depth slices).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from hdu_bench import harness, traffic
from hdu_bench.reference import models as R
from hdu_bench.reference.train_hybrid import Trainer
from hdu_bench.run import load_module
from hdu_bench.weights import make_weights
from hdu_bench.work import counts
from hdu_bench.work import train_hybrid as work


def pool(params: dict, b: int, s: int, d: int, seed: int, device, num_classes: int) -> list:
    """[{"image": (b, s, s, d, 1) float32, "label": (b, s, s, d) int32}] x
    pool, on ``device``, from ``traffic._gen``'s generator of (seed, 5)."""
    n = params["pool"]
    gen = traffic._gen(device, seed, 5)
    images = torch.randn((n, b, s, s, d, 1), generator=gen, device=device)
    images = images.mul_(params["intensity_sd"]).round_()
    labels = torch.randint(0, num_classes, (n, b, s, s, d), generator=gen, device=device,
                           dtype=torch.int32)
    return [{"image": images[i], "label": labels[i]} for i in range(n)]


class _Pool:
    """The window's batches, in order, cycling over the pool."""

    def __init__(self, batches):
        self.batches, self.k = batches, 0

    def next(self):
        b = self.batches[self.k % len(self.batches)]
        self.k += 1
        return b


def _state(h, weights, gseed):
    """(the program's Config, a TrainState of the end-to-end stage)."""
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.train import trainer
    from hdenseunet_tpu_torch.train.optimizer import make_optimizer

    cfg, tr = h.cfg, h.cfg["train"]
    c = Config()
    c.model.preset = cfg["port_preset"]
    c.model.compute_dtype = cfg["precision"]
    c.model.num_classes = cfg["num_classes"]
    c.model.input_size, c.model.input_cols = tr["crop_size"], tr["input_cols"]
    c.train.arch = tr["arch"]
    c.train.batch = tr["batch_per_gpu"]
    c.train.lr, c.train.momentum, c.train.nesterov = tr["lr"], tr["momentum"], True
    c.train.loss_weights = tuple(tr["loss_weights"])
    c.train.mask_boundary_slices = tr["mask_boundary_slices"]
    c.train.remat, c.train.remat_policy = True, tr["remat_policy"]
    c.train.steps_per_dispatch = h.traffic["steps_per_dispatch"]
    model = trainer.build_model(c, c.train.arch, device=h.device)
    model.load_state_dict(weights)
    opt, labels = make_optimizer(model, c.train.arch, c.train.lr, c.train.momentum, c.train.nesterov)
    state = trainer.TrainState(
        model, opt, labels, c.train.arch, torch.Generator().manual_seed(gseed),
        torch.tensor(c.train.loss_weights, dtype=torch.float32, device=h.device),
    )
    return c, state


def _protocol():
    """``runners/train.py`` as a private module, its ``_state`` and
    ``Trainer`` this stage's."""
    mod = load_module(Path(__file__).with_name("train.py"), "hdu_bench_train_protocol")
    mod._state, mod.Trainer = _state, Trainer
    return mod


T = _protocol()


def _plant_half_batch(h) -> None:
    """The hybrid's loss over the first half of the batch alone."""
    from hdenseunet_tpu_torch.train import trainer

    loss = trainer.weighted_crossentropy_hybrid

    def half(logits, labels, *a, **k):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n], *a, **k)

    h.undo.append((trainer, "weighted_crossentropy_hybrid", loss))
    trainer.weighted_crossentropy_hybrid = half


def _compare(h, what: str, prog: dict, ref: dict, keep, convs, label: str) -> None:
    """``runners/train.py``'s numbers of ``what`` over ``keep``, then over
    its leaves outside the 2D branch (suffixed ``_3d``)."""
    T._put(h, what, T._gaps(prog, ref, keep, convs, label))
    deep = [k for k in keep if not k.startswith("net2d.")]
    gaps = T._gaps(prog, ref, deep, convs, label + ", 3D branch and head")
    numbers = {f"{what}_gap_3d": gaps["median"], f"conv_{what}_gap_3d": gaps["conv_median"],
               "conv_worst_gap_3d": gaps["conv"]}
    for name, value in numbers.items():
        if name in h.checks.limits:
            h.checks.put(name, value)
        else:
            print(f"not compared: {name} {value:.4g}", file=sys.stderr)


def run(h) -> dict:
    cfg, tr = h.cfg, h.cfg["train"]
    nc, K = cfg["num_classes"], h.traffic["steps_per_dispatch"]
    b, s, d = tr["batch_per_gpu"], tr["crop_size"], tr["input_cols"]
    out = {"metrics": {}, "units": {"setup_s": "s", h.traffic["metric"]: "ms/step"}}
    weights = make_weights(cfg, h.seed, h.device)
    gseed = int(np.random.SeedSequence([h.seed, 4]).generate_state(1, np.uint64)[0] >> 1)
    feed = _Pool(pool(h.traffic, b, s, d, h.seed, h.device, nc))
    first, second = [], []
    if h.control:
        first = [feed.next() for _ in range(3)]
        prog = T._follow(h, R.Fp8Ops(), weights, None, first, T._dropout_seeds(gseed, 3))
        out["device"] = harness.device_record(h.device, h.chips)
        out["attempted"], out["failed"] = 3, 0
    else:
        if h.fault == "half_batch":
            _plant_half_batch(h)
        prog = T._program(h, out, weights, gseed, feed, first, second)

    with h.reference_precision():
        seeds = T._dropout_seeds(gseed, 2 * K)
        ref = T._follow(h, R.Float32Ops(), weights, None, first, seeds[:3])
        med = np.median(list(ref["grad"].values()))
        keep = [k for k, v in ref["grad"].items() if v >= T.MIN_GRAD_SHARE * med]
        print(f"losses {prog['loss']} against {ref['loss']}", file=sys.stderr)
        loss_gap = [max(harness.relative_gap(p, r, 0.0) for p, r in zip(prog["loss"], ref["loss"]))]
        convs = {k for k in weights if k.endswith(".kernel")}
        _compare(h, "grad", prog["grad"], ref["grad"], keep, convs, "first gradient")
        _compare(h, "update", prog["update"], ref["update"], keep, convs, "change after three")
        if "replayed" in prog:
            rp = prog["replayed"]
            ref2 = T._follow(h, R.Float32Ops(), rp["start"]["params"], rp["start"]["momentum"], second,
                             seeds[K:])
            loss_gap.append(max(harness.relative_gap(p, r, 0.0) for p, r in zip(rp["loss"], ref2["loss"])))
            _compare(h, "update", rp["update"], ref2["update"], keep, convs,
                     "change over the replayed call")
        print(f"loss gap (not compared) {max(loss_gap):.4g}", file=sys.stderr)
    pk = counts.peaks(out["device"]["kind"])
    out["work"] = {"flops": work.train_step(cfg, b, s), "peaks": pk,
                   "k1_bound_s": work.k1_bound_s(cfg, b * d, s, pk)}
    return out
