"""Segmentation metrics: the device half of the train step, on tensors, and
the host half of the predict path, on numpy arrays.

Counterpart of the JAX package's ``metrics.py``. ``confusion_counts`` and
``dice_jaccard`` are its device-side train metrics; ``seg_metrics``
follows the reference's metric(gt, pred, spacing) with smooth=0.001 in
every denominator, and ``hausdorff_95`` is the undirected 95th-percentile
Hausdorff distance from scipy distance transforms.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

SMOOTH = 0.001


def confusion_counts(gt: torch.Tensor, pred: torch.Tensor):
    """Binary confusion counts of {0,1}-valued tensors of any shape, as f32
    scalars: (tp, fp, fn, tn, gt_sum, pred_sum, intersection, union)."""
    g, p = gt.float(), pred.float()
    tp = (g * p).sum()
    fp = (p * (1 - g)).sum()
    fn = (g * (1 - p)).sum()
    tn = ((1 - g) * (1 - p)).sum()
    return tp, fp, fn, tn, g.sum(), p.sum(), tp, tp + fp + fn


def dice_jaccard(gt: torch.Tensor, pred: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(jaccard, dice) with the reference's smooth=0.001."""
    tp, fp, fn, tn, g_sum, p_sum, inter, union = confusion_counts(gt, pred)
    return inter / (union + SMOOTH), 2 * inter / (g_sum + p_sum + SMOOTH)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels: mask XOR its erosion (MONAI get_mask_edges)."""
    if not mask.any():
        return np.zeros_like(mask, dtype=bool)
    eroded = ndimage.binary_erosion(mask)
    return mask ^ eroded


def hausdorff_95(
    gt: np.ndarray, pred: np.ndarray, spacing: Sequence[float]
) -> float:
    """95th-percentile Hausdorff distance (undirected), physical units."""
    gt = np.asarray(gt, dtype=bool)
    pred = np.asarray(pred, dtype=bool)
    if not gt.any() or not pred.any():
        return float("inf")
    # Crop both masks to the union bounding box + 1 background voxel of
    # margin (MONAI's get_mask_edges does the same): the EDT cost scales
    # with the crop, not the volume — this is what keeps the host-side
    # metric off the predict pipeline's critical path. EXACT: all surface
    # voxels and their mutual distances live inside the box, and erosion
    # border behavior is preserved (where fg touches the array border the
    # crop border coincides with it; elsewhere the margin supplies the
    # background neighbor) — pinned by the brute-force oracle test.
    union = gt | pred
    crop = []
    for ax in range(union.ndim):
        other = tuple(i for i in range(union.ndim) if i != ax)
        idx = np.flatnonzero(union.any(axis=other))
        crop.append(
            slice(max(int(idx[0]) - 1, 0), min(int(idx[-1]) + 2, union.shape[ax]))
        )
    gt = gt[tuple(crop)]
    pred = pred[tuple(crop)]
    s_gt = _surface(gt)
    s_pred = _surface(pred)
    if not s_gt.any() or not s_pred.any():
        return float("inf")
    spacing = np.asarray(spacing, dtype=np.float64)
    dt_gt = ndimage.distance_transform_edt(~s_gt, sampling=spacing)
    dt_pred = ndimage.distance_transform_edt(~s_pred, sampling=spacing)
    d_pred_to_gt = dt_gt[s_pred]
    d_gt_to_pred = dt_pred[s_gt]
    return float(
        max(np.percentile(d_pred_to_gt, 95), np.percentile(d_gt_to_pred, 95))
    )


def seg_metrics(
    gt: np.ndarray,
    pred: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
):
    """Reference ``metric()`` semantics (metric.py:20-75).

    gt/pred: integer masks of any (broadcast-compatible) shape.
    Without spacing -> (jaccard, dice); with spacing ->
    (precision, recall, jaccard, dice, hd95).
    """
    gdth = np.asarray(gt).astype(int).squeeze()
    pred_i = np.asarray(pred).astype(int).squeeze()

    gdth_sum = gdth.sum()
    pred_sum = pred_i.sum()
    intersection = gdth & pred_i
    union = gdth | pred_i
    intersection_sum = np.count_nonzero(intersection)
    union_sum = np.count_nonzero(union)

    tp = intersection.sum()

    jaccard = intersection_sum / (union_sum + SMOOTH)
    dice = 2 * intersection_sum / (gdth_sum + pred_sum + SMOOTH)

    if spacing is None:
        return jaccard, dice

    precision = tp / (pred_sum + SMOOTH)
    recall = tp / (gdth_sum + SMOOTH)
    hd95 = hausdorff_95(gdth > 0, pred_i > 0, spacing)
    return precision, recall, jaccard, dice, hd95


def multiclass_seg_metrics(
    gt: np.ndarray,
    pred: np.ndarray,
    n_classes: int,
    spacing: Optional[Sequence[float]] = None,
):
    """Macro-averaged per-foreground-class metrics (capability extension —
    the reference's metric() is binary-only). Classes absent from both gt
    and pred are skipped."""
    gt = np.asarray(gt).squeeze()
    pred = np.asarray(pred).squeeze()
    per_class = []
    for c in range(1, n_classes):
        g = gt == c
        p = pred == c
        if not g.any() and not p.any():
            continue
        per_class.append(seg_metrics(g.astype(int), p.astype(int), spacing))
    if not per_class:
        return (0.0, 0.0) if spacing is None else (0.0, 0.0, 0.0, 0.0, float("inf"))
    finite = np.asarray(
        [[v if np.isfinite(v) else np.nan for v in row] for row in per_class],
        dtype=np.float64,
    )
    return tuple(np.nanmean(finite, axis=0))
