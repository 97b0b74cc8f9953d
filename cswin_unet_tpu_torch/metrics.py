"""Evaluation metrics on the host: Dice coefficient and HD95.

The port's copy of ``cswin_unet_tpu.metrics`` (the reference's medpy-based
per-case metrics, ``utils.py:48-58``, without the medpy dependency):

  * binary Dice on host numpy;
  * HD95 = the 95th percentile of the *concatenated* directed surface
    distances, from the euclidean distance transform of each mask's
    boundary (medpy's ``__surface_distances``: boundary voxels =
    mask & ~binary_erosion(mask), distances sampled at the other boundary).

Edge rules of ``calculate_metric_percase`` (utils.py:48-58): pred>0 & gt==0
-> (1, 0); pred empty -> (0, 0). The EDT is scipy's; the device twin is
``ops.edt.volume_metrics_device``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    inter = np.count_nonzero(pred & gt)
    denom = np.count_nonzero(pred) + np.count_nonzero(gt)
    if denom == 0:
        return 0.0
    return 2.0 * inter / denom


def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from boundary voxels of `a` to the boundary of `b`."""
    a = a.astype(bool)
    b = b.astype(bool)
    conn = ndimage.generate_binary_structure(a.ndim, 1)
    a_border = a ^ ndimage.binary_erosion(a, structure=conn, iterations=1)
    b_border = b ^ ndimage.binary_erosion(b, structure=conn, iterations=1)
    dt = ndimage.distance_transform_edt(~b_border)
    return dt[a_border]


def hd95(pred: np.ndarray, gt: np.ndarray) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy convention)."""
    d1 = _surface_distances(pred, gt)
    d2 = _surface_distances(gt, pred)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def metric_per_case(pred: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """(dice, hd95) for one binary class with the reference's edge rules."""
    pred = pred > 0
    gt = gt > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_binary(pred, gt), hd95(pred, gt)
    elif pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0
    else:
        return 0.0, 0.0


def volume_metrics(prediction: np.ndarray, label: np.ndarray, num_classes: int):
    """Per-class (dice, hd95) for classes 1..C-1 (background excluded),
    reference utils.py:88-90."""
    return [
        metric_per_case(prediction == i, label == i) for i in range(1, num_classes)
    ]
