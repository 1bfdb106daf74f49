"""Training steps and the host training loop (counterpart of
hdenseunet_tpu/train/trainer.py), data-parallel over the 'data' mesh.

Stages (reference recipes):
  '2d'      — train_2ddense.py: DenseUNet-2D on (B,H,W,3) slabs, per-center-slice
              labels, weighted CE, everything trainable.
  '3dpart'  — train_hybrid.py -arch 3dpart: hybrid with the whole 2D branch
              frozen; boundary z-slices masked from the loss.
  'end2end' — train_hybrid.py -arch end2end: hybrid with 2D convs/Scales
              training, all 2D BNs frozen.

A step is forward, loss (K2), backward, the SGD update and the BN-state
merge, all queued on the device without a host sync; ``train`` syncs only
where it drains the losses, as the JAX loop does. Its phases are the
program's spans (``utils.profiling``): ``put``, ``forward``, ``backward``,
``optimizer`` (zero_grad, then the update) and ``bn_merge``; a replayed
group is one ``replay``. Inside ``forward`` the hybrid stages record
``branch2d``, ``branch3d``, ``hff`` (``models/hybrid.py``) and ``loss``.
The model, the optimizer and the moving statistics are updated in place.
``train`` also takes the cross-stage warm start, checkpoints
(``train/checkpoint.py``) and resume.

A step repeats itself: the same weights, batch and seed give the same bits
(cuDNN restricted to its deterministic algorithms, :func:`repeatable`; the
pools' backwards and the dropout masks of ``models/layers.py``).
``steps_per_dispatch`` K > 1 (:func:`make_multi_step`, the counterpart of
JAX's ``lax.scan`` over K steps) captures one step in a CUDA graph and
replays it K times a group, one ``cudaGraphLaunch`` a step instead of
~11 k kernel launches; the graphed steps equal eager ones bit for bit.

Data parallelism (``mesh``, ``core/mesh.py``): one process per card, each
feeding its rows of the global batch. Live BatchNorm statistics and the
loss are the global batch's (``models/layers.py``, ``ops/wce.py``), so
each rank's backward gives its rows' share of the global loss's gradient;
after ``backward()`` one all-reduce of one flat buffer sums the shares, and
every rank takes the same SGD step. This is not DDP: the reduction does not
overlap the backward, but its one collective comes after every collective
of the backward (the live statistics' reductions, run again by remat), in
the same order on every rank, the frozen and the unread parameters need no
special case, and the model stays a plain module for the scorer, the
checkpoints and the parity tools. The result does not depend on the number
of ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config
from ..core.initializers import init_model
from ..core.mesh import (
    all_reduce_, axis_group, axis_rank, axis_size, check_batch_divisible, make_mesh, replicate,
)
from ..models import denseunet2d, hybrid
from ..models import layers as L
from ..ops import build
from ..parallel.multihost import PinnedFeed, put_batch
from ..utils.guards import NaNGuard
from ..utils.profiling import annotate
from ..weights.convert import match_to_model
from . import checkpoint as ckpt_lib
from .loss import weighted_crossentropy_2d, weighted_crossentropy_hybrid
from .optimizer import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    labels: dict  # {layer: {leaf: 'train' | 'freeze'}}
    arch: str
    generator: torch.Generator  # host generator: one dropout seed per step
    loss_weights: torch.Tensor  # (C,) float32 on the model's device
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.loss_weights.device


def build_model(cfg: Config, arch: str, *, device=None) -> torch.nn.Module:
    """The stage's model, uninitialised: the 2D DenseUNet for '2d' (with
    ``cfg.model.reduction``), else the hybrid (trainer.py:57-81)."""
    if arch == "2d":
        return denseunet2d.DenseUNet2D(
            reduction=cfg.model.reduction, num_classes=cfg.model.num_classes, device=device,
            **denseunet2d.PRESETS[cfg.model.preset],
        )
    return hybrid.HDenseUNet(
        preset=cfg.model.preset, num_classes=cfg.model.num_classes, device=device
    )


def create_train_state(cfg: Config, arch: str | None = None, *, device="cuda", seed: int | None = None):
    """Model from the port's seeded initializer, the stage's optimizer,
    step 0 and the dropout generator, on ``device``."""
    arch = arch or cfg.train.arch
    seed = cfg.train.seed if seed is None else seed
    model = init_model(build_model(cfg, arch), seed).to(device)
    opt, labels = make_optimizer(
        model, arch, cfg.train.lr, cfg.train.momentum, cfg.train.nesterov
    )
    weights = torch.tensor(cfg.train.loss_weights, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    return TrainState(model, opt, labels, arch, gen, weights)


def forward_loss(
    model, batch: dict, ctx: L.Ctx | None, *, arch: str, cfg: Config, weights, mesh=None
):
    """The stage's loss on a device batch (trainer.py:84-125); ``ctx`` None
    is the eval forward (moving statistics, no dropout). Under ``mesh`` the
    batch is this rank's rows and the loss the global batch's. The hybrid
    stages run the 3D branch in ``cfg.model``'s form (``layout3d``,
    ``stem_s2d``); under 'dhwc' dropout keeps elements by their index in the
    d-major memory order, another draw of the same distribution."""
    image = batch["image"].to(getattr(torch, cfg.model.compute_dtype))
    if arch == "2d":
        _, logits = model(image, ctx, bn_frozen=False, decoder_dropout=0.3)
        return weighted_crossentropy_2d(logits, batch["label"], weights, mesh)
    logits = model(
        image, ctx, arch=arch, layout3d=cfg.model.layout3d, stem_s2d=cfg.model.stem_s2d
    )
    with annotate("loss"):
        if cfg.train.mask_boundary_slices:
            return weighted_crossentropy_hybrid(logits, batch["label"], weights, mesh)
        return weighted_crossentropy_2d(
            logits.reshape(-1, logits.shape[-1]), batch["label"].reshape(-1), weights, mesh
        )


@contextlib.contextmanager
def repeatable():
    """cuDNN restricted to its deterministic algorithms while open: with
    the pools' and the dropout's forms in ``models/layers.py``, a step's
    backward then sums in the same order on every run."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def draw_seed(state: TrainState) -> int:
    """The next step's dropout seed, one draw of the host generator, which a
    checkpoint keeps."""
    return int(torch.randint(0, 2**62, (1,), generator=state.generator))


def device_step(state: TrainState, batch: dict, seed: torch.Tensor, cfg: Config, mesh=None):
    """Forward, loss, backward, the gradient sum over ranks, the SGD update
    and the BN-state merge on device tensors (``seed`` a 0-d int64 tensor),
    with no host sync and no change to host state: what a captured graph
    replays. Returns the loss, a device scalar."""
    ctx = L.Ctx(
        seed, device=state.device, remat=cfg.train.remat, remat_policy=cfg.train.remat_policy,
        mesh=mesh,
    )
    with annotate("optimizer"):
        state.optimizer.zero_grad(set_to_none=True)
    with repeatable():
        with annotate("forward"):
            loss = forward_loss(
                state.model, batch, ctx, arch=state.arch, cfg=cfg, weights=state.loss_weights,
                mesh=mesh,
            )
        with annotate("backward"):
            loss.backward()
    with annotate("optimizer"):
        group = axis_group(mesh)
        if group is not None:  # one bucket: every rank's share of the gradient, summed
            all_reduce_([p.grad for p in state.model.parameters() if p.grad is not None], group)
        state.optimizer.step()
    with torch.no_grad(), annotate("bn_merge"):  # BN-state merge (module.py:237-242), once per step
        for bn, (mean, var) in ctx.new_stats.items():
            bn.moving_mean.copy_(mean)
            bn.moving_variance.copy_(var)
    return loss.detach()


def train_step(state: TrainState, batch: dict, cfg: Config, mesh=None) -> torch.Tensor:
    """One optimizer step on a host (numpy) or device batch; returns the
    loss as a device scalar without waiting for it. Gradients stay in the
    parameters' ``.grad`` until the next step. Under ``mesh`` the batch is
    this rank's rows of the global batch (trainer.py:128-155): the loss,
    the live statistics and the summed gradients are the global batch's,
    the same on every rank."""
    dev = state.device
    with annotate("put", str(state.step)):
        batch = put_batch(batch, dev) if isinstance(batch["image"], np.ndarray) else batch
        seed = put_batch({"seed": np.array([draw_seed(state)])}, dev)["seed"][0]
    loss = device_step(state, batch, seed, cfg, mesh)
    L.unfreeze_bn_scale(state.model)
    state.step += 1
    return loss


class MultiStep:
    """K optimizer steps per call (trainer.py:157-191, ``lax.scan`` over a
    stacked batch), built by :func:`make_multi_step`.

    A call takes K host batches, stacked (``{key: (K, B, ...)}``, as
    :func:`stack_batches` makes them) or as a list of K batch dicts, or a
    list of K batches already on the device (the CLI's prefetch), and draws
    K seeds from the host generator; host arrays and the seeds reach the
    card in one pinned copy per array (``PinnedFeed``, which writes a
    list's batches straight into its pinned slots). On the card the first call runs its K steps eagerly:
    that is the warm-up (cuDNN's first calls, the kernels' build) and its
    steps count. The second captures one step
    (:func:`device_step`) on a side stream, reading fixed input tensors, and
    every call from then on replays it K times: per step, a device copy of
    the group's slot into the fixed inputs, one graph launch, and a copy of
    the loss into a (K,) buffer, which is cloned before the next call
    writes it. Nothing the graph reads is rebound after the capture, only
    written in place: parameters and their ``.grad``, momentum buffers, BN
    moving statistics and the kernels' scratch. A capture that fails
    raises; there is no fallback to eager steps. On the CPU every call runs
    its steps eagerly, and there is no graph.

    The kernel wrappers' launch counters see a captured launch once, at the
    capture: ``replays`` counts the steps replayed, ``capture_seconds`` the
    capture's host time.
    """

    def __init__(self, state: TrainState, cfg: Config, mesh, k: int):
        self.state, self.cfg, self.mesh, self.k = state, cfg, mesh, k
        self.feed, self.seeds = PinnedFeed(state.device), PinnedFeed(state.device)
        self.graph = None
        self.calls = self.replays = 0
        self.capture_seconds = None

    def __call__(self, stacked) -> torch.Tensor:
        """K steps on ``stacked`` batches (a dict of (K, B, ...) arrays or
        a list of K batches); returns their losses as a (K,) device tensor
        without waiting for them."""
        st, k = self.state, self.k
        eager = st.device.type != "cuda" or self.calls == 0
        if not eager and self.graph is None:
            self._capture(stacked)
        with annotate("put", str(st.step)):
            seeds = np.array([draw_seed(st) for _ in range(k)], dtype=np.int64)
            group = self._put(stacked, seeds)
        if eager:
            losses = torch.stack([
                device_step(st, {"image": group["image"][i], "label": group["label"][i]},
                            group["seed"][i], self.cfg, self.mesh)
                for i in range(k)
            ])
        else:
            with annotate("replay"):
                for i in range(k):
                    for key, t in self._inputs.items():
                        t.copy_(group[key][i])
                    self.graph.replay()
                    self._losses[i].copy_(self._loss)
                losses = self._losses.clone()
            self.replays += k
        self.calls += 1
        L.unfreeze_bn_scale(st.model)
        st.step += k
        return losses

    def _put(self, stacked, seeds) -> dict:
        """The group's image, label and seed arrays on the model's device."""
        pick = lambda b: {"image": b["image"], "label": b["label"]}
        if not isinstance(stacked, list):
            batch = self.feed.put(pick(stacked))
        elif isinstance(stacked[0]["image"], torch.Tensor):  # the device prefetch's batches
            batch = {k: torch.stack([b[k] for b in stacked]) for k in ("image", "label")}
        else:
            batch = self.feed.put([pick(b) for b in stacked])
        return {**batch, **self.seeds.put({"seed": seeds})}

    def _capture(self, stacked) -> None:
        st = self.state
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(st.device)
        build.reserve_scratch(stream)
        one = stacked[0] if isinstance(stacked, list) else {k: v[0] for k, v in stacked.items()}
        self._inputs = {
            "image": torch.empty(tuple(one["image"].shape), device=st.device,
                                 dtype=torch.as_tensor(one["image"][:0]).dtype),
            "label": torch.empty(tuple(one["label"].shape), device=st.device, dtype=torch.int32),
            "seed": torch.empty((), device=st.device, dtype=torch.int64),
        }
        self._losses = torch.empty(self.k, dtype=torch.float32, device=st.device)
        graph = torch.cuda.CUDAGraph()
        st.optimizer.zero_grad(set_to_none=True)  # the graph's backward makes .grad
        with torch.cuda.graph(graph, stream=stream):
            batch = {"image": self._inputs["image"], "label": self._inputs["label"]}
            self._loss = device_step(st, batch, self._inputs["seed"], self.cfg, self.mesh)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0


def make_multi_step(state: TrainState, cfg: Config, mesh=None, k: int = 8) -> MultiStep:
    """K train steps per dispatch (trainer.py:157-191): a :class:`MultiStep`
    over ``state``, which it updates in place; numerically identical to K
    :func:`train_step` calls. Under a gloo process group it raises
    NotImplementedError: gloo's collectives cannot be captured in a CUDA
    graph. NCCL's are captured as they are."""
    group = axis_group(mesh)
    if group is not None and dist.get_backend(group) == "gloo":
        raise NotImplementedError(
            "steps_per_dispatch > 1 captures the step in a CUDA graph, and gloo's collectives "
            "cannot be captured: use NCCL, or steps_per_dispatch 1"
        )
    return MultiStep(state, cfg, mesh, k)


def stack_batches(batches: list) -> dict:
    """[{k: (B, ...)}] * K -> {k: (K, B, ...)} for :func:`make_multi_step`."""
    keys = batches[0].keys()
    return {k: np.stack([b[k] for b in batches]) for k in keys}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, cfg: Config, mesh=None) -> torch.Tensor:
    """Forward-only loss: no dropout, moving statistics (trainer.py:199-211);
    under ``mesh`` the global batch's loss from this rank's rows."""
    batch = put_batch(batch, state.device) if isinstance(batch["image"], np.ndarray) else batch
    return forward_loss(
        state.model, batch, None, arch=state.arch, cfg=cfg, weights=state.loss_weights, mesh=mesh
    )


class MetricsLogger:
    """Epoch/batch loss logs + throughput counters (trainer.py:214-262).

    Writes ``history/lossepoch.txt`` like the reference's modified
    ProgbarLogger (Keras-2.0.8/keras/callbacks.py:311-314) and
    ``history/lossbatch.txt``, plus slices/sec/chip: ``world_size`` ranks
    share the global batch (one card each). Only the ``primary`` rank
    writes the files.
    """

    def __init__(
        self, save_path: str, slices_per_sample: int = 1, *, world_size: int = 1,
        primary: bool = True,
    ):
        self.dir = Path(save_path) / "history"
        self.primary = primary
        if primary:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.slices_per_sample = slices_per_sample
        self.world_size = world_size
        self._epoch_losses: list[float] = []
        self._last_epoch_loss: float | None = None
        self._t0 = time.perf_counter()
        self._samples = 0

    def last_loss(self) -> float | None:
        """Mean loss of the epoch in progress, else the completed epoch's."""
        if self._epoch_losses:
            return float(np.mean(self._epoch_losses))
        return self._last_epoch_loss

    def log_step(self, loss: float, batch_size: int):
        self._epoch_losses.append(float(loss))
        self._samples += batch_size
        if self.primary:
            with open(self.dir / "lossbatch.txt", "a") as f:
                f.write(f"{float(loss):.6f}\n")

    def end_epoch(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        self._last_epoch_loss = (
            float(np.mean(self._epoch_losses)) if self._epoch_losses else None
        )
        stats = {
            "loss": self._last_epoch_loss if self._last_epoch_loss is not None else float("nan"),
            "samples_per_sec": self._samples / dt,
            "slices_per_sec_per_chip": self._samples * self.slices_per_sample / dt / self.world_size,
        }
        if self.primary:
            with open(self.dir / "lossepoch.txt", "a") as f:
                f.write(f"{stats['loss']:.6f}\n")
        self._epoch_losses.clear()
        self._t0 = time.perf_counter()
        self._samples = 0
        return stats


def train(
    cfg: Config,
    batch_iterator,
    *,
    mesh=None,
    max_steps: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    init_weights: dict | None = None,
    log_fn=print,
    device="cuda",
):
    """Host training loop (trainer.py:265-406): host or device batches ->
    device steps; losses drain (sync, NaN check, log) at
    ``log_every_steps``, at each epoch end, before every checkpoint save and
    at the end of the run. ``init_weights`` ({layer: {leaf: array}}) seeds
    the model by layer name; with ``checkpoint_dir`` the state is saved
    every ``checkpoint_every_steps`` and at the end, and ``resume`` first
    restores the newest save there. Returns the final :class:`TrainState`.

    ``mesh`` (default :func:`~..core.mesh.make_mesh`: every rank of the
    process group, or this process alone): ``batch_iterator`` yields this
    rank's rows, ``cfg.train.batch / ranks`` of them, of each global batch
    of ``cfg.train.batch``; ``device`` is this rank's card. The state starts
    as rank 0's (a broadcast after the warm start or the restore), rank 0
    writes the checkpoints and the history, and the losses are global.

    ``cfg.train.steps_per_dispatch`` K > 1 groups the batches by K, as the
    JAX loop does (trainer.py:314-405): each full group is one
    :class:`MultiStep` call (on the card, from the second group on, K
    replays of one captured step); a trailing partial group, and a group
    that would overshoot ``max_steps``, run as single steps; logging,
    epochs and checkpoints fire when a step count crosses their cadence.
    """
    mesh = make_mesh(device) if mesh is None else mesh
    check_batch_divisible(cfg.train.batch, mesh)
    arch = cfg.train.arch
    state = create_train_state(cfg, arch, device=device)
    if init_weights is not None:
        # cross-stage warm start (reference: by-name/subgroup HDF5 loaders,
        # topology.py:3107/:3171/:3250)
        report = match_to_model(init_weights, state.model, strict_shapes=False)
        log_fn(
            f"warm start: {len(report['loaded'])} layers loaded, "
            f"{len(report['skipped'])} skipped, "
            f"{len(report['mismatched'])} shape-mismatched"
        )
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = ckpt_lib.Checkpointer(checkpoint_dir, mesh=mesh)
        if resume and ckpt.restore_latest(state) is not None:
            log_fn(f"resumed from step {state.step}")
    replicate(mesh, state.model)
    k = max(1, cfg.train.steps_per_dispatch)
    multi = make_multi_step(state, cfg, mesh, k) if k > 1 else None
    slices = cfg.model.input_cols if arch != "2d" else 1
    metrics = MetricsLogger(
        cfg.train.save_path, slices_per_sample=slices, world_size=axis_size(mesh),
        primary=axis_rank(mesh) == 0,
    )
    nan_guard = NaNGuard()
    steps_per_epoch = cfg.train.resolved_steps_per_epoch()
    total = max_steps if max_steps is not None else steps_per_epoch * cfg.train.epochs
    pending: list = []  # device losses, fetched at the drain cadence only

    def drain(at_step: int):
        """Sync, NaN-check and log every pending loss; always before a
        save, so a poisoned state is never written."""
        for val in pending:
            v = float(val)
            nan_guard.check(v, at_step)
            metrics.log_step(v, cfg.train.batch)
        pending.clear()

    def batch_groups():
        """Lists of up to k batches; a trailing partial group is kept."""
        group: list = []
        for batch in batch_iterator:
            group.append(batch)
            if len(group) == k:
                yield group
                group = []
        if group:
            yield group

    step = 0
    for group in batch_groups():
        if step >= total:
            break
        remaining = total - step
        if multi is not None and len(group) == k and remaining >= k:
            pending.extend(multi(group).unbind())
            n_steps = k
        else:
            # a partial tail group, or a full group that would overshoot
            # max_steps: clamped single steps, no batch silently dropped
            for batch in group[:remaining]:
                pending.append(train_step(state, batch, cfg, mesh))
            n_steps = min(len(group), remaining)
        prev, step = step, step + n_steps

        def crossed(n: int) -> bool:
            # a multiple of n lies in (prev, step]: robust to k-step jumps
            return step // n > prev // n

        if crossed(cfg.train.log_every_steps) or step >= total or crossed(steps_per_epoch):
            drain(step)
        if crossed(steps_per_epoch):
            stats = metrics.end_epoch()
            log_fn(
                f"epoch {step // steps_per_epoch}: loss={stats['loss']:.4f} "
                f"({stats['slices_per_sec_per_chip']:.1f} slices/s/chip)"
            )
        if ckpt is not None and crossed(cfg.train.checkpoint_every_steps):
            drain(step)
            ckpt.save(state.step, state, metric=metrics.last_loss())
    if ckpt is not None:
        drain(step)
        ckpt.save(state.step, state, metric=metrics.last_loss())
    if multi is not None:
        log_fn(
            f"steps_per_dispatch {k}: {multi.calls * k} steps in groups, {multi.replays} of them "
            "replayed from one captured CUDA graph"
            + (f" (captured in {multi.capture_seconds:.2f} s)" if multi.graph is not None else "")
        )
    return state
