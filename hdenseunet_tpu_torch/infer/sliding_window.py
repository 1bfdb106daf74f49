"""Host-loop z-axis sliding-window inference (counterpart of
hdenseunet_tpu/infer/sliding_window.py; reference lib/funcs.py:4-52).

``InferConfig.device_resident=False`` serves through this loop instead of
the device-resident scorer: each batch of ``window_batch`` unique windows
goes to the device, comes back as interior softmax probabilities, and is
accumulated on the host in float32 numpy with its multiplicity, as the
reference averages overlapping windows after dropping each window's two
edge slices.

Under a data-parallel ``mesh`` (the JAX package shards each window batch
over its 'data' axis, sliding_window.py:76-99) rank r of W scores windows
[r*wb/W, (r+1)*wb/W) of every batch, and one all-reduce of a zeroed batch
buffer, each rank's block filled in, gives every rank the whole batch's
probabilities, as JAX's fetch of the sharded result does; the host
accumulation is then the single process's.

``window_starts`` is pure numpy, copied from the JAX package and pinned to
the original by tests; the device-resident scorer imports it from here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import axis_group, axis_rank, axis_size, replicate
from ..models import layers as L


def window_starts(z: int, mini_z: int, maxi_z: int, cfg) -> list[int]:
    """Window start offsets, replicating lib/funcs.py:19-28 exactly.

    ``mini_z``/``maxi_z`` are the liver-mask z-extent; margins -5/+10 around
    it (:19-20), stride = input_cols // 4 (:12), and starts past ``z - cols``
    clamp to the final full window (:26-28).
    """
    cols = cfg.input_cols
    stride = cfg.window_stride
    right = int(min(z, maxi_z + cfg.liver_margin_hi) - cols)
    left = max(0, min(mini_z - cfg.liver_margin_lo, right))
    starts = []
    for s in range(left, right + stride, stride):
        starts.append(min(s, z - cols))
    return starts


@torch.inference_mode()
def _window_probs(model, batch_vol, *, arch: str):
    """(B, H, W, cols, 1) windows in the compute dtype -> (B, H, W, cols-2, C)
    float32 interior softmax."""
    probs = torch.softmax(model(batch_vol, arch=arch).float(), dim=-1)
    return probs[:, :, :, 1:-1, :]  # drop window-edge z slices (funcs.py:33)


class WindowPredictor:
    """Window scorer for one model and config on ``device``, or on every
    rank of ``mesh`` (module docstring).

    Takes over ``model`` as :class:`~.device_pipeline.DeviceVolumeScorer`
    does (``layers.prepare_serving``), so its weights must be final; under
    a mesh they are rank 0's, and ``window_batch`` must be a multiple of
    the ranks."""

    def __init__(
        self,
        model,
        cfg,
        *,
        arch: str = "end2end",
        compute_dtype: str = "float32",
        num_classes: int = 3,
        device="cuda",
        mesh=None,
    ):
        if max(1, cfg.window_batch) % axis_size(mesh):
            raise ValueError(
                f"window_batch {cfg.window_batch} is not a multiple of the mesh's "
                f"{axis_size(mesh)} ranks"
            )
        self.cfg = cfg
        self.arch = arch
        self.num_classes = num_classes
        self.mesh = mesh
        self.device = torch.device(device)
        self.dtype = getattr(torch, compute_dtype)
        self.model = replicate(mesh, L.prepare_serving(model, self.device, self.dtype))

    @torch.inference_mode()
    def _score_batch(self, wins: np.ndarray) -> np.ndarray:
        """This rank's block of the batch's windows, scored; under a mesh the
        other ranks' blocks arrive through one all-reduce."""
        n = len(wins) // axis_size(self.mesh)
        lo = axis_rank(self.mesh) * n
        batch = torch.from_numpy(wins[lo : lo + n]).to(self.device).to(self.dtype)
        probs = _window_probs(self.model, batch, arch=self.arch)
        group = axis_group(self.mesh)
        if group is None:
            return probs.cpu().numpy()
        whole = probs.new_zeros((len(wins), *probs.shape[1:]))
        whole[lo : lo + n] = probs
        dist.all_reduce(whole, group=group)
        return whole.cpu().numpy()

    def predict_volume(self, vol: np.ndarray, mini_z: int, maxi_z: int):
        """vol: (X, Y, Z) mean-subtracted CT -> (liver_prob, tumor_prob) (X,Y,Z).

        Equivalent of predict_tumor_inwindow (lib/funcs.py:4-52) with batched
        windows and multiplicity-preserving averaging.
        """
        cfg = self.cfg
        x0, y0 = vol.shape[:2]
        # models downsample 5x by 2: pad in-plane to a multiple of 32 (the
        # reference instead assumes 512^2 inputs, test.py:27); padding is at
        # the high end, repeats the edge, and is cropped back off the scores.
        pad_x = (-x0) % 32
        pad_y = (-y0) % 32
        if pad_x or pad_y:
            vol = np.pad(vol, ((0, pad_x), (0, pad_y), (0, 0)), mode="edge")
        x, y, z = vol.shape
        cols = cfg.input_cols
        assert z >= cols, f"volume depth {z} < window {cols}"
        starts = window_starts(z, mini_z, maxi_z, cfg)
        uniq = sorted(set(starts))
        mult = {s: starts.count(s) for s in uniq}

        score = np.zeros((x, y, z, self.num_classes), np.float32)
        count = np.zeros((z,), np.float32)

        wb = max(1, cfg.window_batch)
        for i in range(0, len(uniq), wb):
            chunk = uniq[i : i + wb]
            wins = np.stack(
                [vol[:, :, s : s + cols] for s in chunk]
            )[..., None].astype(np.float32)
            if len(chunk) < wb:  # pad to the static batch shape
                pad = np.repeat(wins[-1:], wb - len(chunk), axis=0)
                wins = np.concatenate([wins, pad], axis=0)
            probs = self._score_batch(wins)
            for j, s in enumerate(chunk):
                m = mult[s]
                score[:, :, s + 1 : s + cols - 1, :] += m * probs[j]
                count[s + 1 : s + cols - 1] += m

        score /= count[None, None, :, None] + 1e-4  # funcs.py:48
        score = score[:x0, :y0]
        return score[..., self.num_classes - 2], score[..., self.num_classes - 1]
