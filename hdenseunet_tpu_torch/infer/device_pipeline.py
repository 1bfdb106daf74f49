"""Device-resident sliding-window volume scoring (counterpart of
hdenseunet_tpu/infer/device_pipeline.py, the exact dedup-2D path).

Per volume: one h2d of the z-cropped volume in the compute dtype -> for each
stride-aligned run of windows: one 2D pass over the run's unique slice
stacks, the hybrid's 3D branch and HFF head over the run's windows, fp32
softmax, edge-slice drop and multiplicity-weighted accumulate -> overlap
average -> threshold -> 2-bit packed labelmask -> one small d2h. PyTorch
queues the work asynchronously, so ``labelmask_async`` returns before the
card is done and ``labelmask_collect`` waits.

The window-grid helpers are pure numpy, copied from the JAX package
(sliding_window.window_starts, device_pipeline.plan_windows / make_grid /
make_grid_structured) and pinned to the originals by tests.

Ported here: the shipped default (``dedup_2d=True``, ``shared_2d=False``,
``wire_bits=2``, ``device_postprocess=False``). The plain per-window path,
the shared-2D mode, the unpacked wire, the tiled scorer and the device CC
postprocess are later slices and raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hybrid import HDenseUNet
from ..models import layers as L

Z_BUCKET = 64
_WIRE_BUCKET = 16  # wire z rounds up to this


def window_starts(z: int, mini_z: int, maxi_z: int, cfg) -> list[int]:
    """Window start offsets, replicating lib/funcs.py:19-28 exactly."""
    cols = cfg.input_cols
    stride = cfg.window_stride
    right = int(min(z, maxi_z + cfg.liver_margin_hi) - cols)
    left = max(0, min(mini_z - cfg.liver_margin_lo, right))
    starts = []
    for s in range(left, right + stride, stride):
        starts.append(min(s, z - cols))
    return starts


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


def pack_labels(score, thres_liver: float, thres_tumor: float, *, num_classes: int = 3):
    """Threshold -> uint8 mask: bit0 liver-or-tumor, bit1 tumor (test.py:73-77)."""
    liver = score[..., num_classes - 2] >= thres_liver
    tumor = score[..., num_classes - 1] >= thres_tumor
    return (liver | tumor).to(torch.uint8) + 2 * tumor.to(torch.uint8)


def pack2bits(mask, *, pack_z: int | None = None):
    """uint8 labelmask {0,1,3} -> 2-bit wire, 4 z-voxels per byte (lossless);
    ``pack_z`` first crops z. Inverse: :func:`unpack2bits`."""
    if pack_z is not None:
        mask = mask[:, :, :pack_z]
    x, y, z = mask.shape
    assert z % 4 == 0, z
    m = mask.reshape(x, y, z // 4, 4)
    return m[..., 0] + 4 * m[..., 1] + 16 * m[..., 2] + 64 * m[..., 3]


def unpack2bits(buf: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack2bits: (x, y, zq) uint8 -> (x, y, 4*zq)."""
    x, y, q = buf.shape
    out = np.empty((x, y, 4 * q), np.uint8)
    for i in range(4):
        out[:, :, i::4] = (buf >> (2 * i)) & 3
    return out


class DeviceVolumeScorer:
    """Scores whole volumes on one device with the hybrid network.

    Takes over ``model``: moves it to ``device``, casts its conv weights to
    ``compute_dtype`` (BN and Scale stay float32, as in the JAX package) and
    folds every frozen BN∘Scale pair once (``layers.freeze_bn_scale``), so
    the model's weights must be final when the scorer is made.
    """

    def __init__(
        self,
        model: HDenseUNet,
        cfg,
        *,
        arch: str = "end2end",
        compute_dtype: str = "float32",
        num_classes: int = 3,
        device="cuda",
    ):
        if getattr(cfg, "shared_2d", False):
            raise NotImplementedError("shared_2d scoring is not ported yet")
        if not getattr(cfg, "dedup_2d", True) or cfg.window_stride <= 0:
            raise NotImplementedError("only the dedup-2D scoring path is ported")
        if getattr(cfg, "wire_bits", 2) != 2:
            raise NotImplementedError("only the 2-bit packed labelmask wire is ported")
        self.cfg = cfg
        self.arch = arch
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.dtype = getattr(torch, compute_dtype)
        self.model = model.to(self.device).eval()
        for m in self.model.modules():
            if isinstance(m, L.Conv):
                fmt = torch.channels_last if m.ndim == 2 else torch.channels_last_3d
                m.to(dtype=self.dtype, memory_format=fmt)
        L.freeze_bn_scale(self.model)

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
        starts_list = [s - z_lo for s in all_starts]
        cap = -(-plan_windows(zp, self.cfg) // wb) + 1
        starts, weights = make_grid_structured(
            starts_list, wb, self.cfg.window_stride, max_runs=cap
        )
        return dict(
            z_lo=z_lo, z=z, zp=zp, zw=min(zp, -(-z // _WIRE_BUCKET) * _WIRE_BUCKET),
            xp=x0 + (-x0) % 32, yp=y0 + (-y0) % 32,
            wb=wb, starts=starts, weights=weights,
        )

    def _wire(self, vol: np.ndarray, p: dict):
        """The z-crop of the volume, zero-padded to the wire bucket, on the
        device in the compute dtype. bf16 is exact for the clipped,
        mean-subtracted CT integers (every one lies in [-248, 202])."""
        x0, y0, _ = vol.shape
        vol_p = np.zeros((x0, y0, p["zw"]), np.float32)
        vol_p[:, :, : p["z"]] = vol[:, :, p["z_lo"] : p["z_lo"] + p["z"]]
        return torch.from_numpy(vol_p).to(self.dtype).to(self.device)

    @torch.inference_mode()
    def _score(self, vol: np.ndarray, p: dict):
        """Averaged probabilities (xp, yp, zp, C) float32 on the device.

        Runs whose weights are all zero (the plan's bucket padding) are
        skipped, and so are weight-0 windows in the accumulate: both add
        exactly nothing to the JAX program's accumulators, so results are
        identical. Gather indices are clamped as ``jnp.take(mode='clip')``
        and ``lax.dynamic_slice`` clamp them: padding windows of
        right-aligned runs reach past the crop and must read finite values.
        """
        cols, stride = self.cfg.input_cols, self.cfg.window_stride
        x, y, zp, wb = p["xp"], p["yp"], p["zp"], p["wb"]
        inner = cols - 2
        ni = (wb - 1) * stride + cols - 2
        wire = self._wire(vol, p)
        vol_d = F.pad(wire, (0, zp - wire.shape[2], 0, y - wire.shape[1], 0, x - wire.shape[0]))
        asm = torch.from_numpy(assembly_map(wb, cols, stride)).to(self.device)

        score = torch.zeros((x, y, zp, self.num_classes), dtype=torch.float32, device=self.device)
        count = torch.zeros((zp,), dtype=torch.float32, device=self.device)
        for s_i, w_i in zip(p["starts"].astype(np.int64), p["weights"]):
            if not w_i.any():
                continue
            s0 = s_i[0]
            c_idx = s0 + 1 + np.arange(ni)
            # centers [interior..., first edges..., last edges...] -> (z-1, z, z+1)
            prev = np.concatenate([c_idx - 1, s_i, s_i + cols - 2])
            cur = np.concatenate([c_idx, s_i, s_i + cols - 1])
            nxt = np.concatenate([c_idx + 1, s_i + 1, s_i + cols - 1])
            idx = np.clip(np.stack([prev, cur, nxt], axis=-1), 0, zp - 1)  # (N, 3)
            stacks = vol_d[:, :, torch.from_numpy(idx).to(self.device)]  # (x, y, N, 3)
            stacks = stacks.permute(2, 0, 1, 3).contiguous()  # (N, x, y, 3)
            feat2d, logits2d = self.model.net2d(stacks)
            res_w = logits2d[asm].permute(0, 2, 3, 1, 4)  # (wb, x, y, cols, C)
            fea_w = feat2d[asm].permute(0, 2, 3, 1, 4)  # (wb, x, y, cols, F)
            win = np.clip(s_i, 0, zp - cols)[:, None] + np.arange(cols)  # (wb, cols)
            vol_w = vol_d[:, :, torch.from_numpy(win).to(self.device)]  # (x, y, wb, cols)
            vol_w = vol_w.permute(2, 0, 1, 3).unsqueeze(-1)  # (wb, x, y, cols, 1)
            logits = self.model.fuse(vol_w, res_w, fea_w, arch=self.arch)
            probs = torch.softmax(logits.float(), dim=-1)[:, :, :, 1:-1, :]
            for j in range(wb):
                w = float(w_i[j])
                if w == 0.0:
                    continue
                sj = int(s_i[j]) + 1
                score[:, :, sj : sj + inner].add_(probs[j], alpha=w)
                count[sj : sj + inner] += w
        return score / (count[None, None, :, None] + 1e-4)  # funcs.py:48

    @staticmethod
    def _restore_z(arr, z_lo: int, z_full: int):
        """Pad the scored z-crop back to the full volume's z extent (zeros)."""
        z = arr.shape[2]
        if z_lo == 0 and z == z_full:
            return arr
        pad = [0, 0] * (arr.dim() - 3) + [z_lo, z_full - z_lo - z]
        return F.pad(arr, pad)

    def score(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """vol: (X, Y, Z) mean-subtracted -> (X, Y, Z, C) float32 probabilities
        on the device, zero outside the scored z range."""
        x0, y0, z_full = vol.shape
        p = self.plan(vol.shape, mini_z, maxi_z)
        out = self._score(vol, p)[:x0, :y0, : p["z"]]
        return self._restore_z(out, p["z_lo"], z_full)

    def labelmask(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """uint8 (X,Y,Z): bit0 = liver-or-tumor, bit1 = tumor."""
        return self.labelmask_collect(self.labelmask_async(vol, mini_z, maxi_z))

    def labelmask_async(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """Upload and queue one volume's scoring; defer the d2h.

        The mask stays on the device z-cropped to the wire bucket and 2-bit
        packed. Returns a handle for :meth:`labelmask_collect`."""
        x0, y0, z_full = vol.shape
        p = self.plan(vol.shape, mini_z, maxi_z)
        with torch.inference_mode():
            mask = pack_labels(
                self._score(vol, p), self.cfg.thres_liver, self.cfg.thres_tumor,
                num_classes=self.num_classes,
            )
            out = pack2bits(mask, pack_z=p["zw"])
        return out, dict(x0=x0, y0=y0, z=p["z"], z_lo=p["z_lo"], z_full=z_full)

    def labelmask_collect(self, handle) -> np.ndarray:
        """Fetch a labelmask_async handle -> uint8 (X, Y, Z) labelmask,
        cropped to the volume's own x/y (the padding to multiples of 32 also
        carries thresholded output)."""
        dev, m = handle
        buf = unpack2bits(dev.cpu().numpy())
        out = np.zeros((m["x0"], m["y0"], m["z_full"]), np.uint8)
        out[:, :, m["z_lo"] : m["z_lo"] + m["z"]] = buf[: m["x0"], : m["y0"], : m["z"]]
        return out
