"""Segmentation metrics (Dice per case, the LiTS headline numbers).

The reference computes no metrics in-repo — validation went through the LiTS
leaderboard (SURVEY.md §4). The rebuild needs them locally to demonstrate
parity (paper: liver Dice ~0.961, tumor ~0.722; BASELINE.md).
"""
from __future__ import annotations

import numpy as np


def dice(pred: np.ndarray, truth: np.ndarray, *, empty_value: float = 1.0) -> float:
    """Dice = 2|A∩B| / (|A|+|B|) over boolean masks."""
    pred = pred.astype(bool)
    truth = truth.astype(bool)
    denom = pred.sum() + truth.sum()
    if denom == 0:
        return empty_value
    return float(2.0 * np.logical_and(pred, truth).sum() / denom)


def dice_per_class(labelmap: np.ndarray, truth: np.ndarray, num_classes: int = 3) -> dict:
    """Per-class Dice of integer labelmaps. LiTS convention: liver Dice is
    computed on label >= 1 (tumor is inside the liver), tumor on label == 2."""
    out = {}
    for c in range(1, num_classes):
        if c == 1:
            out["liver"] = dice(labelmap >= 1, truth >= 1)
        else:
            out["tumor"] = dice(labelmap == c, truth == c)
    return out


def global_dice(preds: list[np.ndarray], truths: list[np.ndarray]) -> dict:
    """Dice over the union of all cases (LiTS 'global' variant)."""
    inter = {"liver": 0, "tumor": 0}
    denom = {"liver": 0, "tumor": 0}
    for p, t in zip(preds, truths):
        for key, (pm, tm) in {
            "liver": (p >= 1, t >= 1),
            "tumor": (p == 2, t == 2),
        }.items():
            inter[key] += np.logical_and(pm, tm).sum()
            denom[key] += pm.sum() + tm.sum()
    return {
        k: (1.0 if denom[k] == 0 else float(2.0 * inter[k] / denom[k])) for k in inter
    }


def voe(pred: np.ndarray, truth: np.ndarray, *, empty_value: float = 0.0) -> float:
    """Volumetric Overlap Error = 1 - |A∩B| / |A∪B| (LiTS secondary metric)."""
    pred = pred.astype(bool)
    truth = truth.astype(bool)
    union = np.logical_or(pred, truth).sum()
    if union == 0:
        return empty_value
    return float(1.0 - np.logical_and(pred, truth).sum() / union)


def rvd(pred: np.ndarray, truth: np.ndarray, *, empty_value: float = 0.0) -> float:
    """Relative Volume Difference = (|A| - |B|) / |B| (signed; LiTS metric)."""
    pv = float(pred.astype(bool).sum())
    tv = float(truth.astype(bool).sum())
    if tv == 0:
        return empty_value if pv == 0 else np.inf
    return (pv - tv) / tv


def metrics_per_class(labelmap: np.ndarray, truth: np.ndarray) -> dict:
    """Dice/VOE/RVD per LiTS class (liver = label>=1, tumor = label==2)."""
    out = {}
    for key, (pm, tm) in {
        "liver": (labelmap >= 1, truth >= 1),
        "tumor": (labelmap == 2, truth == 2),
    }.items():
        out[key] = {
            "dice": dice(pm, tm),
            "voe": voe(pm, tm),
            "rvd": rvd(pm, tm),
        }
    return out
