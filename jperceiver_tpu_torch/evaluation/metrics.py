"""Depth & layout metrics.

The port's own copy of `jperceiver_tpu/evaluation/metrics.py` (numpy only; the port imports
nothing of the JAX package).

Parity with `mono/core/evaluation/pixel_error.py:7-118`, but the layout
metrics are vectorized confusion-matrix counts (one pass, device-friendly)
instead of the reference's per-class python loops. `mean_iu`/
`mean_precision` keep the reference's exact class-presence semantics so
numbers match: IoU of a class absent from BOTH prediction and GT stays 0
and still divides into the mean (reference initializes `IU = [0]*n_cl`
over the union of observed classes).
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 (`pixel_error.py:27-40`)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def confusion_counts(pred: np.ndarray, gt: np.ndarray, num_classes: int):
    """(num_classes, num_classes) confusion matrix via one bincount."""
    pred = pred.astype(np.int64).ravel()
    gt = gt.astype(np.int64).ravel()
    idx = gt * num_classes + pred
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def _observed_classes(*arrays):
    vals = np.unique(np.concatenate([np.unique(a) for a in arrays]))
    return vals.astype(np.int64)


def mean_iu(pred: np.ndarray, gt: np.ndarray):
    """Per-class IoU over the union of observed classes (`pixel_error.py:80-118`)."""
    classes = _observed_classes(pred, gt)
    n = int(classes.max()) + 1 if classes.size else 1
    cm = confusion_counts(pred, gt, n)
    out = []
    for c in classes:
        inter = cm[c, c]
        gt_c = cm[c, :].sum()
        pred_c = cm[:, c].sum()
        if gt_c == 0 or pred_c == 0:
            out.append(0.0)
            continue
        out.append(inter / float(gt_c + pred_c - inter))
    return out


def mean_precision(pred: np.ndarray, gt: np.ndarray):
    """Per-class precision over GT-observed classes (`pixel_error.py:59-77`)."""
    classes = _observed_classes(gt)
    n = int(max(classes.max(), pred.max())) + 1
    cm = confusion_counts(pred, gt, n)
    out = []
    for c in classes:
        pred_c = cm[:, c].sum()
        val = cm[c, c] / float(pred_c) if pred_c else float("nan")
        out.append(0.0 if np.isnan(val) else val)
    return out
