"""Device-resident sliding-window volume scoring (counterpart of
hdenseunet_tpu/infer/device_pipeline.py's ``DeviceVolumeScorer``).

Per volume: one h2d of the z-cropped volume in the compute dtype -> window
runs through the hybrid -> fp32 softmax, edge-slice drop and
multiplicity-weighted accumulate (K3a, ``ops/score.window_accumulate``, one
launch a batch) -> overlap average -> threshold -> labelmask or its 2-bit
wire (K3b, ``ops/score.score_finish``, one launch a volume) -> one small
d2h. PyTorch queues the work asynchronously, so
``labelmask_async`` returns before the card is done and ``labelmask_collect``
waits.

Three scoring paths, as in the JAX package: the exact dedup-2D path (the
default: each stride-aligned run of windows shares one 2D pass over its
unique slice stacks), the exact per-window path (``dedup_2d=False``), and the
shared-2D fast mode (``shared_2d=True``: the 2D branch once per z slice, then
the 3D branch and head per window; an opt-in deviation at window edges).
Wires: the 2-bit packed labelmask (``wire_bits=2``), the uint8 one
(``wire_bits=8``), and with ``device_postprocess`` the final labelmap after
the CC postprocess on the card (``infer/device_postprocess.py``), dense or
bbox-cropped (``sparse_wire``). Every path runs the 3D branch in the form
the config asks for (:func:`forms`): ``layout3d`` and ``stem_s2d``, whose
shipped default is the space-to-depth stem. The host's share of a volume
is in the program's spans (``utils.profiling``): ``upload``, one
``window_batch`` a live batch (its gathers, forward and K3a queued) and
``compose`` (K3b and K4 queued); ``window_batches`` counts the batches and
``stacks_2d`` the slice stacks of the dedup-2D path's 2D passes.

:class:`TiledVolumeScorer` is the x/y/z-tiled scorer (reference
predict_window_mulgpu): windows of (tile, tile, input_cols) over the whole
volume, full-window softmax, a per-voxel count.

The window-grid helpers are pure numpy, copied from the JAX package
(device_pipeline.plan_windows / make_grid / make_grid_structured /
tile_origins; ``window_starts`` lives in ``sliding_window.py``) and pinned
to the originals by tests.

The measurement helpers: ``estimate_flops`` counts the conv FLOPs a
volume's scoring runs (``utils/flops.py``, the real modules on the meta
device); ``compute_timer`` and ``compute_seconds`` time the served scoring
program k times back to back on a wire already on the device, and take the
slope over k, so MFU is ``estimate_flops / compute_seconds /
utils.flops.peak_flops_per_chip()``.

Window parallelism (``mesh``, ``core/mesh.py``; the JAX package shards each
window batch over its 'data' axis, device_pipeline.py:144-150, :1152-1156):
on the dedup-2D and per-window paths, rank r of W scores windows
[r*wb/W, (r+1)*wb/W) of every batch (in the dedup path, a run of its own
with the 2D pass over just the stacks its windows need), accumulates them
into its own score buffer and count, and one all-reduce per volume sums
the buffers before the average. Every rank then holds the same scores and
thresholds, packs and fetches the same labelmask.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.mesh import axis_group, axis_rank, axis_size, replicate
from ..models.hybrid import HDenseUNet
from ..models import layers as L
from ..ops import score as K3
from ..ops.cc import pack2bits
from ..ops.score import pack_labels  # noqa: F401  (the scorer's threshold, re-exported)
from ..utils import profiling
from .device_postprocess import compose_final, compose_packed
from .sliding_window import window_starts

Z_BUCKET = 64
_WIRE_BUCKET = 16  # wire z rounds up to this


def plan_windows(z_pad: int, cfg) -> int:
    """Max number of unique windows any volume in this z-bucket can need."""
    return (z_pad - cfg.input_cols) // cfg.window_stride + 1


def make_grid(starts_list: list[int], wb: int, n_batches: int):
    """(starts, weights) arrays of static shape (n_batches, wb); unique
    windows weigh their multiplicity, padding slots 0."""
    uniq = sorted(set(starts_list))
    total = n_batches * wb
    assert len(uniq) <= total, (len(uniq), total)
    starts = np.zeros((total,), np.int32)
    weights = np.zeros((total,), np.float32)
    for i, s in enumerate(uniq):
        starts[i] = s
        weights[i] = starts_list.count(s)
    return starts.reshape(n_batches, wb), weights.reshape(n_batches, wb)


def make_grid_structured(
    starts_list: list[int],
    wb: int,
    stride: int,
    run_bucket: int = 4,
    max_runs: int | None = None,
):
    """(starts, weights) with EVERY batch an arithmetic run s0, s0+stride, ...

    On-grid starts chunk into runs of ``wb``, each right-aligned and extended
    backward with weight-0 slots; the reference's clamped final start, when
    off-grid, gets its own run. The run count pads up to a multiple of
    ``run_bucket`` (capped at ``max_runs``) with weight-0 copies of run 0.
    Weights carry each unique start's multiplicity exactly once.
    """
    uniq = sorted(set(starts_list))
    mult = {s: starts_list.count(s) for s in uniq}
    lo = uniq[0]
    on_grid = [s for s in uniq if (s - lo) % stride == 0]
    off_grid = [s for s in uniq if (s - lo) % stride != 0]
    assert len(off_grid) <= 1, off_grid  # only the final clamp can be off-grid

    runs: list[list[int]] = []

    def emit(seq_starts: list[int]):
        for i in range(0, len(seq_starts), wb):
            chunk = seq_starts[i : i + wb]
            end = chunk[-1]
            run = [end - stride * (wb - 1 - j) for j in range(wb)]
            if run[0] < 0:  # left-shift impossible; pad forward from 0 instead
                run = [chunk[0] + stride * j for j in range(wb)]
            runs.append(run)

    emit(on_grid)
    if off_grid:
        emit(off_grid)

    n_runs = -(-len(runs) // run_bucket) * run_bucket
    if max_runs is not None:
        n_runs = min(n_runs, max(max_runs, len(runs)))
    while len(runs) < n_runs:
        runs.append(list(runs[0]))

    starts = np.zeros((len(runs), wb), np.int32)
    weights = np.zeros((len(runs), wb), np.float32)
    counted: set[int] = set()
    for r, run in enumerate(runs):
        for j, s in enumerate(run):
            starts[r, j] = s
            if s in mult and s not in counted:
                weights[r, j] = mult[s]
                counted.add(s)
    assert counted == set(uniq), (sorted(counted), uniq)
    return starts, weights


def assembly_map(wb: int, cols: int, stride: int) -> np.ndarray:
    """Static (wb, cols) map: window j, position p -> row of the run's 2D batch.

    The batch holds the NI = (wb-1)*stride + cols-2 interior stacks (shared
    by consecutive windows), then each window's first-edge stack, then each
    window's last-edge stack (device_pipeline.py:1115-1123)."""
    ni = (wb - 1) * stride + cols - 2
    asm = np.zeros((wb, cols), np.int64)
    for j in range(wb):
        asm[j, 0] = ni + j
        asm[j, cols - 1] = ni + wb + j
        for p in range(1, cols - 1):
            asm[j, p] = stride * j + p - 1
    return asm


def unpack2bits(buf: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack2bits: (x, y, zq) uint8 -> (x, y, 4*zq)."""
    x, y, q = buf.shape
    out = np.empty((x, y, 4 * q), np.uint8)
    for i in range(4):
        out[:, :, i::4] = (buf >> (2 * i)) & 3
    return out


def summarize(score):
    """Scalar digest (sum of liver and of tumour probabilities, max tumour
    probability) of the whole score buffer, padding included, as JAX's
    _summarize."""
    return torch.stack([score[..., 1].sum(), score[..., 2].sum(), score[..., 2].max()])


def forms(cfg) -> dict:
    """The 3D branch's form that ``cfg`` (an InferConfig) asks the scorers
    for, as the hybrid's keywords (device_pipeline.py:392-393): the layout
    and the space-to-depth stem, each defaulting to the direct form."""
    return dict(
        layout3d=getattr(cfg, "layout3d", "hwdc"), stem_s2d=getattr(cfg, "stem_s2d", False)
    )


def crop_pack(final, x0: int, y0: int, z0: int, *, sx: int, sy: int, sz: int):
    """2-bit wire of the (sx, sy, sz) crop of the device labelmap at (x0, y0,
    z0); the caller keeps the crop inside the labelmap."""
    return pack2bits(final[x0 : x0 + sx, y0 : y0 + sy, z0 : z0 + sz])


class DeviceVolumeScorer:
    """Scores whole volumes on one device with the hybrid network, or on
    every rank of ``mesh``, each on its own device (module docstring).

    Takes over ``model``: moves it to ``device``, casts its conv weights to
    ``compute_dtype`` (BN and Scale stay float32, as in the JAX package) and
    folds every frozen BN∘Scale pair once (``layers.freeze_bn_scale``), so
    the model's weights must be final when the scorer is made. Under a mesh
    the weights are rank 0's (a broadcast), ``window_batch`` must be a
    multiple of the ranks, and the shared-2D mode is refused.
    """

    _SPARSE_BUCKET = (64, 64, 16)  # bbox crop sizes round up to these
    _CHUNK_2D = 16  # z slices per 2D pass in the shared-2D mode's phase A

    def __init__(
        self,
        model: HDenseUNet,
        cfg,
        *,
        arch: str = "end2end",
        compute_dtype: str = "float32",
        num_classes: int = 3,
        device="cuda",
        mesh=None,
    ):
        if getattr(cfg, "wire_bits", 2) not in (2, 8):
            raise ValueError(f"wire_bits must be 2 or 8, got {cfg.wire_bits}")
        self.cfg = cfg
        self.arch = arch
        self.num_classes = num_classes
        self.shared_2d = getattr(cfg, "shared_2d", False)
        self.mesh = mesh
        ranks = axis_size(mesh)
        if ranks > 1 and self.shared_2d:
            raise ValueError("the shared-2D mode takes no mesh")
        if max(1, cfg.window_batch) % ranks:
            raise ValueError(
                f"window_batch {cfg.window_batch} is not a multiple of the mesh's {ranks} ranks"
            )
        self.device = torch.device(device)
        self.dtype = getattr(torch, compute_dtype)
        self.model = replicate(mesh, L.prepare_serving(model, self.device, self.dtype))
        self.forms = forms(cfg)

    def _bucketed(self, z: int) -> int:
        need = max(z, self.cfg.input_cols)
        return -(-need // Z_BUCKET) * Z_BUCKET

    def plan(self, vol_shape, mini_z: int, maxi_z: int) -> dict:
        """Static execution plan for a volume shape + liver z-range
        (device_pipeline.py:282-327)."""
        x0, y0, z_full = vol_shape
        all_starts = window_starts(z_full, mini_z, maxi_z, self.cfg)
        z_lo = min(all_starts)
        z_hi = min(z_full, max(all_starts) + self.cfg.input_cols)
        z = z_hi - z_lo
        zp = self._bucketed(z)
        wb = max(1, self.cfg.window_batch)
        if self.shared_2d:
            wb = min(wb, 4)  # phase B's window gathers scale with wb
        starts_list = [s - z_lo for s in all_starts]
        dedup = (
            getattr(self.cfg, "dedup_2d", True) and not self.shared_2d
            and self.cfg.window_stride > 0
        )
        if dedup:
            cap = -(-plan_windows(zp, self.cfg) // wb) + 1
            starts, weights = make_grid_structured(
                starts_list, wb, self.cfg.window_stride, max_runs=cap
            )
        else:
            # batches for the actual liver z-range, rounded up to 4 batches
            need = len(set(starts_list))
            n_batches = -(-max(1, -(-need // wb)) // 4) * 4
            n_batches = min(n_batches, -(-plan_windows(zp, self.cfg) // wb))
            starts, weights = make_grid(starts_list, wb, n_batches)
        return dict(
            z_lo=z_lo, z=z, zp=zp, zw=min(zp, -(-z // _WIRE_BUCKET) * _WIRE_BUCKET),
            xp=x0 + (-x0) % 32, yp=y0 + (-y0) % 32,
            wb=wb, dedup=dedup, starts=starts, weights=weights,
        )

    def estimate_flops(self, vol_shape, mini_z: int, maxi_z: int) -> float:
        """Analytic conv FLOPs that scoring this volume runs
        (device_pipeline.py:329-359): every batch of the plan with a
        nonzero weight, its weight-0 padding windows included (they run).
        Batches whose weights are all zero, the plan's bucket padding, are
        skipped by :meth:`_score` and not counted; the JAX program runs and
        counts them."""
        from ..utils.flops import hybrid_window_batch_flops

        p = self.plan(vol_shape, mini_z, maxi_z)
        runs, wb, cols = int(p["weights"].any(axis=1).sum()), p["wb"], self.cfg.input_cols
        count = lambda **kw: hybrid_window_batch_flops(
            x=p["xp"], y=p["yp"], cols=cols, preset=self.model.preset,
            num_classes=self.num_classes, arch=self.arch, **kw,
        )
        if self.shared_2d:
            # phase A: one 2D pass per buffer slice; phase B: 3D + head per window
            f2d_all = count(wb=1, n_stacks_2d=p["zp"]) - count(wb=1, n_stacks_2d=0)
            return runs * count(wb=wb, n_stacks_2d=0) + f2d_all
        n_stacks = (wb - 1) * self.cfg.window_stride + cols - 2 + 2 * wb if p["dedup"] else wb * cols
        return runs * count(wb=wb, n_stacks_2d=n_stacks)

    def compute_timer(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """``timed(k) -> wall seconds`` of k runs of the served scoring
        program (:meth:`_score`, then :func:`summarize`) back to back on one
        wire already on the device, ending on the fetched digest of the last
        run, which ``timed.digest`` keeps. The device is synchronised before
        the clock starts. The first call at a shape carries cuDNN's
        first-call cost: warm every k that will be timed
        (device_pipeline.py:449-487)."""
        import time

        p = self.plan(vol.shape, mini_z, maxi_z)
        vol_d = self._wire(vol, p)

        def timed(k: int) -> float:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(k):
                digest = summarize(self._score(vol_d, p))
            timed.digest = digest.cpu().numpy()  # the fetch waits for the device
            seconds = time.perf_counter() - t0
            assert np.isfinite(timed.digest).all(), timed.digest
            return seconds

        return timed

    def compute_seconds(
        self, vol: np.ndarray, mini_z: int, maxi_z: int, *,
        k_small: int = 1, k_big: int = 3, reps: int = 2, detail: bool = False,
    ):
        """Device seconds of scoring one volume: the slope
        (t(k_big) - t(k_small)) / (k_big - k_small) of :meth:`compute_timer`,
        each endpoint the minimum over ``reps`` calls; the per-call cost
        (the sync, the digest fetch, the host's queueing ahead of the card)
        appears in both endpoints and cancels (device_pipeline.py:489-528).
        Both k are warmed first. ``detail`` returns the endpoints too."""
        timed = self.compute_timer(vol, mini_z, maxi_z)
        timed(k_small), timed(k_big)  # warm both
        t_small = sorted(timed(k_small) for _ in range(reps))
        t_big = sorted(timed(k_big) for _ in range(reps))
        slopes = [max((tb - ts) / (k_big - k_small), 1e-9) for ts, tb in zip(t_small, t_big)]
        if detail:
            return {"seconds": slopes[0], "slopes": slopes, "t_small": t_small, "t_big": t_big}
        return slopes[0]

    def _wire(self, vol: np.ndarray, p: dict):
        """The z-crop of the volume, zero-padded to the compute shape on the
        device in the compute dtype. bf16 is exact for the clipped,
        mean-subtracted CT integers (every one lies in [-248, 202])."""
        x0, y0, _ = vol.shape
        vol_p = np.zeros((x0, y0, p["zw"]), np.float32)
        vol_p[:, :, : p["z"]] = vol[:, :, p["z_lo"] : p["z_lo"] + p["z"]]
        wire = torch.from_numpy(vol_p).to(self.dtype).to(self.device)
        return F.pad(wire, (0, p["zp"] - p["zw"], 0, p["yp"] - y0, 0, p["xp"] - x0))

    def _windows(self, vol_d, s_i):
        """(wb, x, y, cols, 1) windows at starts s_i, each start clamped into
        the buffer as ``lax.dynamic_slice`` clamps it."""
        cols, zp = self.cfg.input_cols, vol_d.shape[2]
        win = np.clip(s_i, 0, zp - cols)[:, None] + np.arange(cols)  # (wb, cols)
        vol_w = vol_d[:, :, torch.from_numpy(win).to(self.device)]  # (x, y, wb, cols)
        return vol_w.permute(2, 0, 1, 3).unsqueeze(-1)

    @torch.inference_mode()
    def _sums(self, vol_d, p: dict):
        """(score (xp, yp, zp, C), count (zp,)) float32 on the device, not
        yet averaged, from the plan ``p``'s wire ``vol_d`` already on the
        device (:meth:`_wire`): every window batch's logits go through
        ``ops.score.window_accumulate`` (K3a).

        Batches whose weights are all zero (the plan's bucket padding) are
        skipped, and so are weight-0 windows in the accumulate: both add
        exactly nothing to the JAX program's accumulators. Every gather index
        is clamped as ``jnp.take(mode='clip')`` and ``lax.dynamic_slice``
        clamp them: padding windows reach past the crop and must read finite
        values. Under a mesh each rank runs its block of every batch's
        windows, and one all-reduce sums the score buffers and counts.
        """
        x, y, zp = vol_d.shape
        c = self.num_classes
        # score buffer and count in one allocation: one all-reduce sums both
        acc = torch.zeros((x * y * zp * c + zp,), dtype=torch.float32, device=self.device)
        score, count = acc[:-zp].view(x, y, zp, c), acc[-zp:]
        ranks, rank = axis_size(self.mesh), axis_rank(self.mesh)
        wb = p["wb"] // ranks  # this rank's windows of every batch
        if self.shared_2d:
            run = self._shared2d_batches(vol_d, p["z"])
        elif p["dedup"]:
            run = self._dedup_batch(vol_d, wb)  # a block of a run is a run
        else:
            run = lambda s_i: self.model(self._windows(vol_d, s_i), arch=self.arch, **self.forms)
        for s_i, w_i in zip(p["starts"].astype(np.int64), p["weights"]):
            s_i, w_i = s_i[rank * wb : (rank + 1) * wb], w_i[rank * wb : (rank + 1) * wb]
            if w_i.any():
                profiling.count("window_batches")
                with profiling.annotate("window_batch"):
                    K3.window_accumulate(score, count, run(s_i), s_i, w_i, cols=self.cfg.input_cols)
        group = axis_group(self.mesh)
        if group is not None:
            dist.all_reduce(acc, group=group)
        return score, count

    @torch.inference_mode()
    def _score(self, vol_d, p: dict):
        """Averaged probabilities (xp, yp, zp, C) float32 on the device
        (:meth:`_sums` over the count plus 1e-4, funcs.py:48)."""
        score, count = self._sums(vol_d, p)
        return score / (count[None, None, :, None] + 1e-4)

    def _finish(self, sums, out: str, pack_z: int | None = None):
        """The thresholded labels (uint8 {0, 1, 3}) or their 2-bit wire over
        the first ``pack_z`` slices, from :meth:`_sums`'s ``sums`` in one
        launch (``ops.score.score_finish``, K3b): the average is not
        written."""
        return K3.score_finish(
            *sums, self.cfg.thres_liver, self.cfg.thres_tumor, out=out, pack_z=pack_z
        )

    def _dedup_batch(self, vol_d, wb: int):
        """One stride-aligned run's logits: a 2D pass over the run's unique
        interior stacks and each window's two replicated edge stacks, then
        the 3D branch and head per window (device_pipeline.py:1128-1178)."""
        cols, stride, zp = self.cfg.input_cols, self.cfg.window_stride, vol_d.shape[2]
        ni = (wb - 1) * stride + cols - 2
        asm = torch.from_numpy(assembly_map(wb, cols, stride)).to(self.device)

        def run(s_i):
            c_idx = s_i[0] + 1 + np.arange(ni)
            # centers [interior..., first edges..., last edges...] -> (z-1, z, z+1)
            prev = np.concatenate([c_idx - 1, s_i, s_i + cols - 2])
            cur = np.concatenate([c_idx, s_i, s_i + cols - 1])
            nxt = np.concatenate([c_idx + 1, s_i + 1, s_i + cols - 1])
            idx = np.clip(np.stack([prev, cur, nxt], axis=-1), 0, zp - 1)  # (N, 3)
            profiling.count("stacks_2d", len(idx))
            stacks = vol_d[:, :, torch.from_numpy(idx).to(self.device)]  # (x, y, N, 3)
            feat2d, logits2d = self.model.net2d(stacks.permute(2, 0, 1, 3).contiguous())
            res_w = logits2d[asm].permute(0, 2, 3, 1, 4)  # (wb, x, y, cols, C)
            fea_w = feat2d[asm].permute(0, 2, 3, 1, 4)  # (wb, x, y, cols, F)
            vol_w = self._windows(vol_d, s_i)
            return self.model.fuse(vol_w, res_w, fea_w, arch=self.arch, **self.forms)

        return run

    def _shared2d_batches(self, vol_d, z_real: int):
        """Phase A (device_pipeline.py:913-940): the 2D branch once over every
        z slice of the buffer, each slice's stack [z-1, z, z+1] clamped at
        the volume's real extent, features and logits kept in the compute
        dtype, (zp, x, y, F) and (zp, x, y, C). Returns phase B's per-batch
        function: each window gathers its slices of both and runs the 3D
        branch and head (:946-967)."""
        x, y, zp = vol_d.shape
        cols = self.cfg.input_cols
        fea = res = None
        for z0 in range(0, zp, self._CHUNK_2D):
            idx = np.arange(z0, min(z0 + self._CHUNK_2D, zp))
            prev, cur, nxt = np.maximum(idx - 1, 0), np.minimum(idx, z_real - 1), np.minimum(idx + 1, z_real - 1)
            sel = torch.from_numpy(np.stack([prev, cur, nxt], axis=-1)).to(self.device)
            f2, l2 = self.model.net2d(vol_d[:, :, sel].permute(2, 0, 1, 3).contiguous())
            if fea is None:
                fea = torch.empty((zp, x, y, f2.shape[-1]), dtype=self.dtype, device=self.device)
                res = torch.empty((zp, x, y, l2.shape[-1]), dtype=self.dtype, device=self.device)
            fea[z0 : z0 + len(idx)] = f2
            res[z0 : z0 + len(idx)] = l2

        def run(s_i):
            win = torch.from_numpy(np.clip(s_i, 0, zp - cols)[:, None] + np.arange(cols)).to(self.device)
            fea_w = fea[win].permute(0, 2, 3, 1, 4)  # (wb, x, y, cols, F)
            res_w = res[win].permute(0, 2, 3, 1, 4)
            vol_w = self._windows(vol_d, s_i)
            return self.model.fuse(vol_w, res_w, fea_w, arch=self.arch, **self.forms)

        return run

    @staticmethod
    def _restore_z(arr, z_lo: int, z_full: int):
        """Pad the scored z-crop back to the full volume's z extent (zeros)."""
        z = arr.shape[2]
        if z_lo == 0 and z == z_full:
            return arr
        pad = [0, 0] * (arr.dim() - 3) + [z_lo, z_full - z_lo - z]
        return F.pad(arr, pad)

    def score(self, vol: np.ndarray, mini_z: int, maxi_z: int, output: str = "probs"):
        """vol: (X, Y, Z) mean-subtracted -> on the device, zero outside the
        scored z range: 'probs' (X, Y, Z, C) float32 probabilities, 'packed'
        the thresholded uint8 mask (X, Y, Z) (bit 0 liver or tumour, bit 1
        tumour), or 'digest' the 3 scalars of :func:`summarize`."""
        if output not in ("probs", "packed", "digest"):
            raise ValueError(f"unknown output {output!r}")
        x0, y0, z_full = vol.shape
        p = self.plan(vol.shape, mini_z, maxi_z)
        if output == "packed":
            with torch.inference_mode():
                probs = self._finish(self._sums(self._wire(vol, p), p), "labels")
        else:
            probs = self._score(self._wire(vol, p), p)
        if output == "digest":
            return summarize(probs)
        return self._restore_z(probs[:x0, :y0, : p["z"]], p["z_lo"], z_full)

    def predict_volume(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """Host-compatible API: (liver_prob, tumor_prob) numpy arrays."""
        score = self.score(vol, mini_z, maxi_z).cpu().numpy()
        return score[..., self.num_classes - 2], score[..., self.num_classes - 1]

    def summarize(self, vol: np.ndarray, mini_z: int, maxi_z: int) -> np.ndarray:
        """Scalar digest only (no volume-sized d2h)."""
        return self.score(vol, mini_z, maxi_z, output="digest").cpu().numpy()

    def labelmask(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """uint8 (X,Y,Z): bit0 = liver-or-tumor, bit1 = tumor."""
        return self.labelmask_collect(self.labelmask_async(vol, mini_z, maxi_z))

    def _ext_bits(self, ext_mask, p: dict, shape):
        """The external mask's z-crop over the wire's zw slices, packed along
        z on the host (``np.packbits``, zw a multiple of 8), on the device."""
        x0, y0, z_full = shape
        z_avail = min(p["zw"], z_full - p["z_lo"])
        crop = np.zeros((x0, y0, p["zw"]), np.uint8)
        crop[:, :, :z_avail] = np.asarray(ext_mask[:, :, p["z_lo"] : p["z_lo"] + z_avail], bool)
        return torch.from_numpy(np.packbits(crop, axis=2)).to(self.device)

    def labelmask_async(self, vol: np.ndarray, mini_z: int, maxi_z: int, ext_mask=None):
        """Upload and queue one volume's scoring; defer the d2h.

        The mask stays on the device z-cropped to the wire bucket, 2-bit
        packed (``wire_bits=2``) or as uint8 (``wire_bits=8``). With
        ``ext_mask`` (the once-dilated external liver mask, full extent,
        its nonzero z range inside [mini_z, maxi_z], which
        ``postprocess.liver_mask_extent`` guarantees) and
        ``device_postprocess`` on, the reference's whole CC postprocess
        (test.py:70-115) is queued after the scoring on the same stream, and
        the wire carries the final {0,1,2} labelmap: 2-bit packed, or with
        ``sparse_wire`` kept on the device for a bbox-cropped fetch.
        ``postprocess_chunk_iters`` changes nothing here (module docstring of
        ``infer/device_postprocess.py``). Returns a handle for
        :meth:`labelmask_collect`."""
        x0, y0, z_full = vol.shape
        bits = int(getattr(self.cfg, "wire_bits", 2))
        dpp = ext_mask is not None and bool(getattr(self.cfg, "device_postprocess", False))
        sparse = dpp and bool(getattr(self.cfg, "sparse_wire", False))
        p = self.plan(vol.shape, mini_z, maxi_z)
        with torch.inference_mode():
            with profiling.annotate("upload"):
                ext_bits = self._ext_bits(ext_mask, p, vol.shape) if dpp else None
                vol_d = self._wire(vol, p)
            kind = "wire" if bits == 2 and not dpp else "labels"
            sums = self._sums(vol_d, p)
            with profiling.annotate("compose"):
                out = self._finish(sums, kind, pack_z=p["zw"])
                if sparse:
                    out = compose_final(out, ext_bits, pack_z=p["zw"])
                elif dpp:
                    out = compose_packed(out, ext_bits, pack_z=p["zw"])
        return out, dict(
            bits=2 if dpp else bits, sparse=sparse,
            x0=x0, y0=y0, z=p["z"], z_lo=p["z_lo"], z_full=z_full,
        )

    def labelmask_collect(self, handle) -> np.ndarray:
        """Fetch a labelmask_async handle -> uint8 (X, Y, Z) labelmask,
        cropped to the volume's own x/y (the padding to multiples of 32 also
        carries thresholded output)."""
        dev, m = handle
        if m["sparse"]:
            return self._collect_sparse(dev, m)
        buf = dev.cpu().numpy()
        if m["bits"] == 2:
            buf = unpack2bits(buf)
        out = np.zeros((m["x0"], m["y0"], m["z_full"]), np.uint8)
        out[:, :, m["z_lo"] : m["z_lo"] + m["z"]] = buf[: m["x0"], : m["y0"], : m["z"]]
        return out

    def _collect_sparse(self, dev, m) -> np.ndarray:
        """Sparse-wire collect (device_pipeline.py:656-696): fetch the 6-int
        bbox, then only the bbox crop, its sizes rounded up to
        ``_SPARSE_BUCKET``. Lossless: outside the bbox the labelmap is zero."""
        final, bbox_dev = dev
        out = np.zeros((m["x0"], m["y0"], m["z_full"]), np.uint8)
        bb = bbox_dev.cpu().numpy()
        if bb[0] > bb[1]:  # empty labelmap
            return out
        xp, yp, zw = final.shape

        def plan_axis(lo, hi, dim, bucket):
            size = min(dim, -(-(int(hi) - int(lo) + 1) // bucket) * bucket)
            return min(int(lo), dim - size), size

        (xs, sx), (ys, sy), (zs, sz) = (
            plan_axis(bb[2 * a], bb[2 * a + 1], dim, bucket)
            for a, (dim, bucket) in enumerate(zip((xp, yp, zw), self._SPARSE_BUCKET))
        )
        crop = unpack2bits(crop_pack(final, xs, ys, zs, sx=sx, sy=sy, sz=sz).cpu().numpy())
        # paste, clipped to the true volume extent (the crop can reach into
        # xy compute padding, zero there, or past the scored z range)
        gx = min(xs + sx, m["x0"])
        gy = min(ys + sy, m["y0"])
        gz_lo = m["z_lo"] + zs
        gz = min(gz_lo + sz, m["z_lo"] + m["z"], m["z_full"])
        if gx > xs and gy > ys and gz > gz_lo:
            out[xs:gx, ys:gy, gz_lo:gz] = crop[: gx - xs, : gy - ys, : gz - gz_lo]
        return out


# ---------------------------------------------------------------------------
# x/y/z-tiled inference (reference lib/funcs.py:54-129 predict_window_mulgpu)
# ---------------------------------------------------------------------------


def tile_origins(dim: int, win: int, step: int) -> list[int]:
    """Tile start offsets along one axis: stride `step`, clamped to dim-win.

    The reference walks range(0, dim-win+step, step) and clamps late inside a
    broken elif chain (funcs.py:74-96) and can double-count or crash on
    remainder batches; here clamped duplicates are deduped (overlap-average
    semantics are unchanged — identical windows carry identical probs).
    """
    assert dim >= win, (dim, win)
    out = sorted({min(s, dim - win) for s in range(0, dim - win + step, step)})
    return out


class TiledVolumeScorer:
    """The reference's x/y/z-tiled inference on one device: windows of
    (tile, tile, input_cols) stepping 2/3 of their size in every axis over
    the whole volume (no liver z-range), ``window_batch`` windows per
    forward. For volumes whose in-plane extent exceeds what a full-frame
    window batch can hold. Takes over ``model`` as
    :class:`DeviceVolumeScorer` does."""

    def __init__(
        self,
        model: HDenseUNet,
        cfg,
        *,
        tile: int = 256,
        arch: str = "end2end",
        compute_dtype: str = "float32",
        num_classes: int = 3,
        device="cuda",
    ):
        if tile % 32:
            raise ValueError(f"tile must be divisible by 32 (got {tile})")
        self.cfg = cfg
        self.tile = tile
        self.arch = arch
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.dtype = getattr(torch, compute_dtype)
        self.model = L.prepare_serving(model, self.device, self.dtype)
        self.forms = forms(cfg)

    def plan(self, vol_shape) -> dict:
        """The padded shape, the window size and the window origins, in the
        order they are scored (device_pipeline.py:810-830)."""
        x0, y0, z0 = vol_shape
        win = (self.tile, self.tile, self.cfg.input_cols)
        padded = tuple(max(d, w) for d, w in zip((x0, y0, z0), win))
        steps = ((win[0] // 3) * 2, (win[1] // 3) * 2, max(1, (win[2] // 3) * 2))
        axes = [tile_origins(d, w, s) for d, w, s in zip(padded, win, steps)]
        origins = [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]
        return dict(padded=padded, win=win, origins=origins, wb=max(1, self.cfg.window_batch))

    @torch.inference_mode()
    def _score_tiles(self, vol: np.ndarray, p: dict):
        """(score, count) on the device over the padded volume: each
        window's full softmax added into score, 1 into each of its voxels'
        count (device_pipeline.py:725-777). Each batch is filled up to
        ``wb`` with weight-0 windows at the origin, which are scored and
        add nothing."""
        x0, y0, z0 = vol.shape
        vol_p = np.zeros(p["padded"], np.float32)
        vol_p[:x0, :y0, :z0] = vol
        vol_d = torch.from_numpy(vol_p).to(self.device).to(self.dtype)
        score = torch.zeros(p["padded"] + (self.num_classes,), dtype=torch.float32, device=self.device)
        count = torch.zeros(p["padded"], dtype=torch.float32, device=self.device)
        (wx, wy, wz), org, wb = p["win"], p["origins"], p["wb"]
        for i in range(0, len(org), wb):
            chunk = org[i : i + wb]
            batch = chunk + [(0, 0, 0)] * (wb - len(chunk))
            wins = torch.stack([vol_d[a : a + wx, b : b + wy, c : c + wz] for a, b, c in batch])
            logits = self.model(wins.unsqueeze(-1), arch=self.arch, **self.forms)
            probs = torch.softmax(logits.float(), dim=-1)
            for j, (a, b, c) in enumerate(chunk):
                score[a : a + wx, b : b + wy, c : c + wz].add_(probs[j])
                count[a : a + wx, b : b + wy, c : c + wz] += 1.0
        return score, count

    def score(self, vol: np.ndarray):
        """vol: (X, Y, Z) mean-subtracted -> (X, Y, Z, C) float32
        probabilities on the device: the sum over windows divided by
        max(count, 1e-4) per voxel (device_pipeline.py:778)."""
        score, count = self._score_tiles(vol, self.plan(vol.shape))
        x0, y0, z0 = vol.shape
        return (score / count.clamp_min(1e-4)[..., None])[:x0, :y0, :z0]

    def predict_volume(self, vol: np.ndarray):
        """(liver_prob, tumor_prob) numpy arrays (X, Y, Z)."""
        score = self.score(vol).cpu().numpy()
        return score[..., self.num_classes - 2], score[..., self.num_classes - 1]
