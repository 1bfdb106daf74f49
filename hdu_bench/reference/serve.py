"""Plain reference of the served volume: the sliding window of the reference
repository's test.py / lib/funcs.py and its connected-component
postprocess (test.py:58-115), in float32 PyTorch and scipy.ndimage.

For one CT volume and its external liver mask:

1. the image minus the mean (test.py:55); the external mask with label 2
   folded into 1 and dilated once (6-connected), its z extent [lo, hi]
   (test.py:58-63);
2. window starts from max(0, min(lo - 5, right)) to right = min(Z, hi + 10)
   - 8 in steps of 2, each clamped to Z - 8, duplicates kept (funcs.py:12-28);
3. every window through the hybrid; the softmax of its logits; its 6
   interior slices added to the score, 1 added to each slice's count
   (funcs.py:30-47); the score over count + 1e-4 (funcs.py:48);
4. liver where class 1 >= 0.5, tumour where class 2 >= 0.9, tumour counted
   as liver (test.py:73-77);
5. the liver's largest 26-connected component, holes filled; the external
   mask dilated once more, its largest component, holes filled; tumour
   inside that, holes filled; labels 1 and 2 (test.py:84-113). Holes are
   filled as scipy's ``binary_fill_holes`` fills them: every background
   voxel not 6-connected to the border.

The 2D network's output on a stack of three slices depends only on those
three slices, so each distinct stack is computed once and shared by the
windows that hold it, and a start that occurs k times is computed once and
weighs k: the same sums in another order.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from . import models as R


def liver_extent(ext_mask: np.ndarray):
    """(the once-dilated external mask, its lowest z, its highest z)."""
    m = np.asarray(ext_mask).copy()
    m[m == 2] = 1
    m = ndimage.binary_dilation(m.astype(bool))
    zs = np.nonzero(m.any(axis=(0, 1)))[0]
    if zs.size == 0:
        return m, 0, m.shape[2] - 1
    return m, int(zs[0]), int(zs[-1])


def window_starts(z: int, lo: int, hi: int, infer) -> list:
    cols, stride = infer["input_cols"], infer["window_stride"]
    right = int(min(z, hi + infer["liver_margin_hi"]) - cols)
    left = max(0, min(lo - infer["liver_margin_lo"], right))
    return [min(s, z - cols) for s in range(left, right + stride, stride)]


def distinct_work(z: int, lo: int, hi: int, infer):
    """(distinct starts with their multiplicity, distinct 2D stacks as
    absolute (prev, cur, next) slice triples) that a volume needs."""
    starts = window_starts(z, lo, hi, infer)
    uniq = sorted(set(starts))
    mult = {s: starts.count(s) for s in uniq}
    offsets = R.window_stacks(infer["input_cols"])
    stacks = sorted({tuple(s + o for o in p) for s in uniq for p in offsets})
    return mult, stacks


def _largest(mask: np.ndarray) -> np.ndarray:
    labels, num = ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
    if num == 0:
        return np.zeros(mask.shape, bool)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    return labels == int(sizes.argmax())


def _fill(mask: np.ndarray) -> np.ndarray:
    bg, num = ndimage.label(~mask)
    outside = np.zeros(num + 1, bool)
    for face in (bg[0], bg[-1], bg[:, 0], bg[:, -1], bg[:, :, 0], bg[:, :, -1]):
        outside[face.ravel()] = True
    outside[0] = False  # label 0 is the mask itself
    return ~outside[bg]


def postprocess(liver: np.ndarray, tumour: np.ndarray, ext_dilated: np.ndarray) -> np.ndarray:
    liver = liver | tumour
    liver_cc = _largest(liver)
    ext_cc = _fill(_largest(ndimage.binary_dilation(ext_dilated)))
    tumour_final = _fill(tumour & ext_cc)
    out = _fill(liver_cc).astype(np.uint8)
    out[tumour_final] = 2
    return out


@torch.no_grad()
def probabilities(ops, vol: np.ndarray, ext_mask: np.ndarray, P, cfg, device, *,
                  chunk_2d: int = 8, chunk_3d: int = 2):
    """(scores (X, Y, Z, C) float32 numpy over count + 1e-4, the dilated
    external mask) of one volume."""
    infer = cfg["infer"]
    x0, y0, z = vol.shape
    ext, lo, hi = liver_extent(ext_mask)
    mult, stacks = distinct_work(z, lo, hi, infer)
    img = torch.from_numpy(np.asarray(vol, np.float32) - infer["mean"]).to(device)
    img = img.permute(2, 0, 1)  # (Z, X, Y)
    nc = cfg["num_classes"]
    row = {s: i for i, s in enumerate(stacks)}
    feats = logits = None
    for i in range(0, len(stacks), chunk_2d):
        part = stacks[i : i + chunk_2d]
        batch = torch.stack([img[list(t)] for t in part])  # (n, 3, X, Y)
        f, l = R.forward_2d(ops, batch, P, cfg, prefix="net2d.")
        if feats is None:
            feats = torch.empty((len(stacks),) + f.shape[1:], device=device)
            logits = torch.empty((len(stacks),) + l.shape[1:], device=device)
        feats[i : i + len(part)], logits[i : i + len(part)] = f, l
    cols = infer["input_cols"]
    offsets = R.window_stacks(cols)
    score = torch.zeros((x0, y0, z, nc), device=device)
    count = torch.zeros((z,), device=device)
    starts = sorted(mult)
    for i in range(0, len(starts), chunk_3d):
        part = starts[i : i + chunk_3d]
        rows = torch.tensor([[row[tuple(s + o for o in p)] for p in offsets] for s in part],
                            device=device)  # (n, cols)
        vol_w = torch.stack([img[s : s + cols] for s in part]).permute(0, 2, 3, 1).unsqueeze(1)
        res = logits[rows].permute(0, 2, 3, 4, 1)  # (n, C, X, Y, cols)
        fea = feats[rows].permute(0, 2, 3, 4, 1)
        prob = torch.softmax(R.fuse(ops, vol_w, res, fea, P, cfg).float(), dim=1)
        for j, s in enumerate(part):
            m = float(mult[s])
            score[:, :, s + 1 : s + cols - 1] += m * prob[j, :, :, :, 1:-1].permute(1, 2, 3, 0)
            count[s + 1 : s + cols - 1] += m
    score /= count[None, None, :, None] + 1e-4
    return score.cpu().numpy(), ext


def raw_labels(scores: np.ndarray, infer) -> np.ndarray:
    """The thresholded labels before the postprocess, coded as the program
    hands them to it: 0, 1 liver, 3 tumour (bit 0 liver or tumour)."""
    nc = scores.shape[-1]
    liver = scores[..., nc - 2] >= infer["thres_liver"]
    tumour = scores[..., nc - 1] >= infer["thres_tumor"]
    return (liver | tumour).astype(np.uint8) + 2 * tumour.astype(np.uint8)


def postprocess_raw(raw: np.ndarray, ext: np.ndarray) -> np.ndarray:
    """:func:`postprocess` of labels coded as :func:`raw_labels` codes them."""
    return postprocess(raw >= 1, raw >= 3, ext)


def disagreement(raw: np.ndarray, ref_raw: np.ndarray, scores: np.ndarray, infer) -> float:
    """The widest margin by which the reference's score lies on its side of
    a threshold at a voxel whose label ``raw`` gives otherwise: the tumour
    score's distance from its threshold where the tumour bits differ, else
    the liver score's; 0 where every label agrees."""
    differ = raw != ref_raw
    if not differ.any():
        return 0.0
    nc = scores.shape[-1]
    s = scores[differ]
    tumour_differs = (raw[differ] >= 3) != (ref_raw[differ] >= 3)
    margin = np.where(tumour_differs, np.abs(s[:, nc - 1] - infer["thres_tumor"]),
                      np.abs(s[:, nc - 2] - infer["thres_liver"]))
    return float(margin.max())
