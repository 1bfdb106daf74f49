"""Train runner: optimizer steps of the 2D stage through the program's
``trainer.train_step`` (``steps_per_dispatch`` 1) or the
``trainer.make_multi_step`` object (K steps a call, captured as a CUDA
graph from its second call on the card).

Set-up makes the weights from the seed, hands them to the program's model
through its state dict, and builds one ``TrainState`` with the program's
optimizer and a dropout-seed generator seeded from the run's seed. The
batches are a pool on the device (``feed: pool``) or the program's own
feed (``feed: real``: ``CropSampler`` with its native core and
``input_pipeline`` over a prepared dataset written to the run's temporary
directory). Set-up drives that state through its first steps with the
window's own call and feed: three single steps, or with K > 1 the first
call (its steps run eagerly) and the second (captured, then replayed).
The window runs steps until ``seconds`` have passed and ends in a device
synchronisation.

``correct``: the float32 reference (``reference/train.py``) follows the
first three steps from the same weights, batches and dropout seeds: each
step's loss, the first gradient by leaf (the program's momentum after one
step, which starts at zero) and each leaf's change after three steps. With
K > 1 it also follows the second call's replayed steps from the program's
state before that call (its parameters and momentum): their losses and
each leaf's change over the call. A leaf's gap is that between the
program's norm and the reference's, over the larger of the reference's
norm and its median leaf's; leaves whose reference gradient is under a
thousandth of the median leaf's are left out. The numbers, of which the
cell's limits name those compared: the median leaf's gaps (``grad_gap``,
``update_gap``), the median convolution kernel's gap of the change
(``conv_update_gap``: about four leaves in five are BatchNorm's and
Scale's, so a fault confined to the kernels' gradients would leave the
median leaf where it was) and the worst kernel's gap of any of them
(``conv_worst_gap``). The worst leaf of all and the losses are printed,
not compared (PERF.md says why).
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from hdu_bench import harness, traffic
from hdu_bench.reference import models as R
from hdu_bench.reference.train import Trainer
from hdu_bench.weights import make_weights
from hdu_bench.work import counts

MIN_GRAD_SHARE = 1e-3  # of the median leaf's reference gradient


def _dropout_seeds(gseed: int, n: int) -> list:
    """The program's per-step dropout seeds: one randint(0, 2^62) draw of
    its host generator a step, the generator seeded with ``gseed``."""
    g = torch.Generator().manual_seed(gseed)
    return [int(torch.randint(0, 2**62, (1,), generator=g)) for _ in range(n)]


def _state(h, weights, gseed):
    from hdenseunet_tpu_torch.core.config import Config
    from hdenseunet_tpu_torch.train import trainer
    from hdenseunet_tpu_torch.train.optimizer import make_optimizer

    cfg, tr = h.cfg, h.cfg["train"]
    c = Config()
    c.model.preset = cfg["port_preset"]
    c.model.compute_dtype = cfg["precision"]
    c.model.num_classes = cfg["num_classes"]
    c.model.input_size = tr["crop_size"]
    c.train.arch = "2d"
    c.train.batch = tr["batch_per_gpu"]
    c.train.lr, c.train.momentum, c.train.nesterov = tr["lr"], tr["momentum"], True
    c.train.loss_weights = tuple(tr["loss_weights"])
    c.train.remat, c.train.remat_policy = True, tr["remat_policy"]
    c.train.steps_per_dispatch = h.traffic["steps_per_dispatch"]
    model = trainer.build_model(c, "2d", device=h.device)
    model.load_state_dict(weights)
    opt, labels = make_optimizer(model, "2d", c.train.lr, c.train.momentum, c.train.nesterov)
    state = trainer.TrainState(
        model, opt, labels, "2d", torch.Generator().manual_seed(gseed),
        torch.tensor(c.train.loss_weights, dtype=torch.float32, device=h.device),
    )
    return c, state


def _trainable(state) -> dict:
    return {k: p for k, p in state.model.named_parameters() if p.requires_grad}


def _norms(tensors: dict) -> dict:
    keys = sorted(tensors)
    vals = torch.stack([tensors[k].detach().float().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _momentum(state) -> dict:
    return {k: state.optimizer.state[p]["momentum_buffer"] for k, p in _trainable(state).items()}


def _gaps(prog: dict, ref: dict, keep, convs, what: str = "") -> dict:
    """Gaps of norms by leaf, |prog - ref| over the larger of the
    reference's norm and its median leaf's: the median leaf's gap
    ("median"), the median convolution kernel's ("conv_median") and the
    worst kernel's ("conv"). The worst leaves of all are printed: they are
    the stem's BN and Scale, whose reference gradient is a sum that cancels
    under the next BatchNorm to 1/4-1/70 of the median leaf's; bfloat16's
    rounding leaves the program's several times the reference's there,
    where a float32 program reads at rounding (PERF.md), so the worst leaf
    is no steady number."""
    med = float(np.median([ref[k] for k in keep]))
    gaps = sorted(((harness.relative_gap(prog[k], ref[k], med), k) for k in keep), reverse=True)
    conv = [g for g, k in gaps if k in convs]
    out = {"median": float(np.median([g for g, _ in gaps])), "conv_median": float(np.median(conv)),
           "conv": conv[0]}
    print(f"{what}: median leaf's norm {med:.4g}; " + ", ".join(f"{k} {v:.4g}" for k, v in out.items())
          + "; worst leaves " + ", ".join(
              f"{k} {g:.3g} ({prog[k]:.4g} vs {ref[k]:.4g})" for g, k in gaps[:3]), file=sys.stderr)
    return out


class _Feed:
    """The batches of the window's call, in order."""

    def __init__(self, h, device, batch, size, nc):
        self.h, self.host = h, None
        if h.traffic["feed"] == "pool":
            self.pool = traffic.train_pool(h.traffic, batch, size, h.seed, device, nc)
            self.k = 0
        else:
            from hdenseunet_tpu_torch.core.config import DataConfig
            from hdenseunet_tpu_torch.data.pipeline import input_pipeline
            from hdenseunet_tpu_torch.data.preprocess import PreparedDataset
            from hdenseunet_tpu_torch.data.sampler import CropSampler

            self.tmp = tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR"))
            traffic.prepared_dataset(h.traffic["dataset"], h.seed, self.tmp.name)
            sampler = CropSampler(PreparedDataset(self.tmp.name), DataConfig(), mode="2d",
                                  input_size=size, seed=h.seed % 2**32)
            self.batches, self.host = input_pipeline(sampler, batch, device)

    def next(self):
        if self.host is not None:
            b = next(self.batches)
            if isinstance(b["image"], np.ndarray):  # the CPU's feed passes arrays through
                b = {k: torch.from_numpy(v) for k, v in b.items()}
            return b
        b = self.pool[self.k % len(self.pool)]
        self.k += 1
        return b

    def close(self):
        if self.host is not None:
            self.host.close()
            self.tmp.cleanup()


def run(h) -> dict:
    cfg = h.cfg
    nc, K = cfg["num_classes"], h.traffic["steps_per_dispatch"]
    batch, size = cfg["train"]["batch_per_gpu"], cfg["train"]["crop_size"]
    out = {"metrics": {}, "units": {"setup_s": "s", h.traffic["metric"]: "ms/step"}}
    weights = make_weights(cfg, h.seed, h.device)
    gseed = int(np.random.SeedSequence([h.seed, 4]).generate_state(1, np.uint64)[0] >> 1)
    feed = _Feed(h, h.device, batch, size, nc)
    first, second = [], []  # the batches of the checked steps
    try:
        if h.control:
            first = [feed.next() for _ in range(3)]
            prog = _follow(h, R.Fp8Ops(), weights, None, first, _dropout_seeds(gseed, 3))
            out["device"] = harness.device_record(h.device, h.chips)
            out["attempted"], out["failed"] = 3, 0
        else:
            prog = _program(h, out, weights, gseed, feed, first, second)
    finally:
        feed.close()

    with h.reference_precision():
        seeds = _dropout_seeds(gseed, 2 * K if K > 1 else 3)
        ref = _follow(h, R.Float32Ops(), weights, None, first, seeds[:3])
        keep = [k for k, v in ref["grad"].items() if v >= MIN_GRAD_SHARE * np.median(list(ref["grad"].values()))]
        print(f"losses {prog['loss']} against {ref['loss']}", file=sys.stderr)
        loss_gap = [max(harness.relative_gap(p, r, 0.0) for p, r in zip(prog["loss"], ref["loss"]))]
        convs = {k for k, v in weights.items() if v.dim() == 4}
        _put(h, "grad", _gaps(prog["grad"], ref["grad"], keep, convs, "first gradient"))
        _put(h, "update", _gaps(prog["update"], ref["update"], keep, convs, "change after three"))
        if "replayed" in prog:
            start = prog["replayed"]["start"]
            ref2 = _follow(h, R.Float32Ops(), start["params"], start["momentum"], second, seeds[K:])
            rp = prog["replayed"]
            loss_gap.append(max(harness.relative_gap(p, r, 0.0) for p, r in zip(rp["loss"], ref2["loss"])))
            _put(h, "update", _gaps(rp["update"], ref2["update"], keep, convs, "change over the replayed call"))
        # not compared: no control or fault reads 3 or 10 times the program (PERF.md)
        print(f"loss gap (not compared) {max(loss_gap):.4g}", file=sys.stderr)
    out["work"] = {"flops": counts.train_step(cfg, batch, size)}
    out["work"]["peaks"] = counts.peaks(out["device"]["kind"])
    return out


def _put(h, what: str, gaps: dict) -> None:
    """Compare the numbers that the cell's limits name; print the others."""
    numbers = {f"{what}_gap": gaps["median"], "conv_worst_gap": gaps["conv"]}
    if what == "update":
        numbers["conv_update_gap"] = gaps["conv_median"]
    for name, value in numbers.items():
        if name in h.checks.limits:
            h.checks.put(name, value)
        else:
            print(f"not compared: {name} {value:.4g}", file=sys.stderr)


def _follow(h, ops, params, momentum, batches, seeds) -> dict:
    """The reference (or the control) over ``batches`` from ``params``:
    each step's loss, the first step's gradient norms, each leaf's change."""
    t = Trainer(params, h.cfg, ops)
    if momentum is not None:
        for k, buf in t.buf.items():
            buf.copy_(momentum[k])
    losses, grad = [], None
    for b, s in zip(batches, seeds):
        loss, grads = t.step(b["image"], b["label"], s)
        losses.append(loss)
        grad = _norms(grads) if grad is None else grad
    update = _norms({k: t.params[k] - params[k] for k in t.buf})
    return {"loss": losses, "grad": grad, "update": update}


def _program(h, out, weights, gseed, feed, first, second) -> dict:
    from hdenseunet_tpu_torch.train import trainer

    c, state = _state(h, weights, gseed)
    h.apply_faults(state=state)
    K = c.train.steps_per_dispatch
    prog: dict = {}
    if K > 1:
        multi = trainer.make_multi_step(state, c, k=K)
        group = lambda: [feed.next() for _ in range(K)]
        seen = []

        def hook(opt, args, kwargs):  # the first call's steps run eagerly
            seen.append(1)
            if len(seen) == 1:
                prog["grad"] = _norms(_momentum(state))
            if len(seen) == 3:
                prog["update"] = _norms({k: p - weights[k] for k, p in _trainable(state).items()})

        handle = state.optimizer.register_step_post_hook(hook)
        g1 = group()
        first.extend(g1[:3])
        prog["loss"] = multi(g1)[:3].cpu().tolist()
        handle.remove()
        start = {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
                 "momentum": {k: v.clone() for k, v in _momentum(state).items()}}
        g2 = group()
        second.extend(g2)
        losses2 = multi(g2).cpu().tolist()
        prog["replayed"] = {
            "start": start, "loss": losses2,
            "update": _norms({k: p - start["params"][k] for k, p in _trainable(state).items()}),
        }
        def call():
            with h.spans.span("step_call"):
                return multi(group())
    else:
        p0 = {k: p.detach().clone() for k, p in _trainable(state).items()}
        losses = []
        for i in range(3):
            b = feed.next()
            first.append({k: v.clone() for k, v in b.items()})
            losses.append(trainer.train_step(state, b, c))
            if i == 0:
                prog["grad"] = _norms(_momentum(state))
        prog["loss"] = torch.stack(losses).cpu().tolist()
        prog["update"] = _norms({k: p - p0[k] for k, p in _trainable(state).items()})

        def call():
            with h.spans.span("feed_wait"):
                b = feed.next()
            with h.spans.span("step_call"):
                return trainer.train_step(state, b, c)[None]

    harness.synchronize(h.device)
    out["metrics"]["setup_s"] = time.perf_counter() - h.t_start

    def loop(seconds=None, calls=None):
        losses, n = [], 0
        t0 = time.perf_counter()
        while (n < calls) if calls is not None else (time.perf_counter() - t0 < seconds or n == 0):
            losses.append(call())
            n += 1
        harness.synchronize(h.device)
        return torch.cat(losses), time.perf_counter() - t0

    losses, seconds = loop(seconds=h.seconds)
    out["spans"] = dict(h.spans.totals)
    steps = losses.numel()
    out["metrics"][h.traffic["metric"]] = seconds / steps * 1e3
    out["count"] = steps
    out["device"] = harness.device_record(h.device, h.chips)
    out["failed"] = int((~torch.isfinite(losses)).sum())
    if h.trace:
        with harness.profiled(h.spans, h.device, h.scratch) as summary:
            traced, _ = loop(calls=h.traffic["trace_calls"])
        out["trace"], out["traced_units"] = summary, traced.numel()
        out["failed"] += int((~torch.isfinite(traced)).sum())
        steps += traced.numel()
    out["attempted"] = steps + (2 * K if K > 1 else 3)
    del state
    gc.collect()
    if torch.device(h.device).type == "cuda":
        torch.cuda.empty_cache()
    return prog
