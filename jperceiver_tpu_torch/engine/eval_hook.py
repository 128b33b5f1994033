"""Per-epoch evaluation: depth metrics and BEV layout mIoU/mAP
(counterpart of `jperceiver_tpu/engine/eval_hook.py`).

Depth protocol (the reference's `eval_hooks.py:148-179`): disparity ->
depth (0.1..100) -> resized to the ground truth (PIL's "F"-mode bilinear)
-> ground truth in (1e-3, 80) -> Eigen crop (rows 40.8%..99.2%, columns
3.6%..96.4%) -> median scaling (or a fixed 36 for stereo) -> clamped ->
`compute_depth_errors`. Layouts: the argmax over the class axis against
the label map, class 1's IoU and precision, per sample.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from .. import parallel as dist
from ..evaluation.metrics import AverageMeter, compute_depth_errors, mean_iu, mean_precision
from .infer import make_eval_step

MIN_DEPTH, MAX_DEPTH = 1e-3, 80.0  # `eval_hooks.py:14-15`
DEPTH_KEYS = ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "ratio"]
# The fixed key list of the ranks' sum under data parallel: every rank
# contributes every key, whether its shard gave it or not.
SUM_KEYS = DEPTH_KEYS + ["road_iou", "road_map", "vehicle_iou", "vehicle_map"]
_ROAD_TYPES = ("static", "static_raw", "Argo_static", "Argo_both")
_VEHICLE_TYPES = ("dynamic", "Argo_dynamic", "Argo_both")


def eigen_crop_mask(gt: np.ndarray) -> np.ndarray:
    """Valid ground truth inside the Eigen crop (`eval_hooks.py:161-165`)."""
    h, w = gt.shape
    mask = np.logical_and(gt > MIN_DEPTH, gt < MAX_DEPTH)
    crop = np.zeros_like(mask)
    crop[int(0.40810811 * h): int(0.99189189 * h),
         int(0.03594771 * w): int(0.96405229 * w)] = 1
    return np.logical_and(mask, crop)


def depth_metrics_single(disp: np.ndarray, gt: np.ndarray,
                         stereo_scale: bool = False) -> dict | None:
    """disp: (h, w) sigmoid disparity; gt: (H, W) sparse metric depth. None
    when no ground-truth pixel lies in the crop."""
    from PIL import Image

    h, w = gt.shape
    disp_r = np.asarray(Image.fromarray(disp.astype(np.float32), mode="F")
                        .resize((w, h), Image.BILINEAR))
    min_disp, max_disp = 1.0 / 100.0, 1.0 / 0.1
    depth = 1.0 / (min_disp + (max_disp - min_disp) * disp_r)
    mask = eigen_crop_mask(gt)
    if mask.sum() == 0:
        return None
    d, g = depth[mask], gt[mask]
    ratio = 36.0 if stereo_scale else np.median(g) / np.median(d)  # `eval_hooks.py:171-174`
    d = np.clip(d * ratio, MIN_DEPTH, MAX_DEPTH)
    abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 = compute_depth_errors(g, d)
    return dict(abs_rel=abs_rel, sq_rel=sq_rel, rmse=rmse, rmse_log=rmse_log,
                a1=a1, a2=a2, a3=a3, ratio=ratio)


class EvalHook:
    """`hook(step, epoch) -> metrics` for `Trainer.eval_hook`: the model's
    eval forward over `val_loader` (at most `max_batches` batches) on
    `device` (CUDA by default), the depth metrics where a batch has
    `gt_depth`, the road/vehicle layout metrics of the branches the config's
    `type` scores, `n_eval_samples` (the samples the `_valid` mask keeps)
    and `fps` (images over the forwards' seconds, the device synchronised
    before each reading of the clock). The model is the step's own, so
    `step` is not read.

    Under a process group each rank evaluates its shard of the loader
    (`process_index`/`process_count`, the padded tail masked by `_valid`);
    the metrics' sums and counts and `n_eval_samples` are all-reduced (a
    tensor on the model's device), so every rank returns the summary of the
    whole dataset, each sample counted once. `fps` stays the rank's own."""

    def __init__(self, model, val_loader: Iterable, cfg, with_depth: bool = True,
                 with_layout: bool = True, max_batches: int | None = None, device=None):
        self.loader = val_loader
        self.cfg = cfg
        self.with_depth = with_depth
        self.with_layout = with_layout
        self.max_batches = max_batches
        self.eval_step = make_eval_step(model, cfg, device)
        self.device = next(model.parameters()).device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, step=None, epoch: int | None = None) -> dict:
        meters: dict[str, AverageMeter] = {}

        def upd(name, val):
            meters.setdefault(name, AverageMeter()).update(float(val), 1)

        stereo = bool(self.cfg.get("stereo_scale", False))
        model_type = self.cfg.get("type", "static")
        fwd_time, n_imgs, n_valid = 0.0, 0, 0
        for bi, batch in enumerate(self.loader):
            if self.max_batches is not None and bi >= self.max_batches:
                break
            gt_depth = batch.pop("gt_depth", None)
            valid = batch.pop("_valid", None)
            n_b = int(np.asarray(batch["color"]).shape[0])
            valid = np.ones(n_b, bool) if valid is None else np.asarray(valid)
            color = torch.as_tensor(batch["color_aug"], dtype=torch.float32, device=self.device)
            self._sync()
            t0 = time.perf_counter()
            out = self.eval_step({"color_aug": color})
            self._sync()
            fwd_time += time.perf_counter() - t0
            n_imgs += n_b
            n_valid += int(valid.sum())
            disp = out["disp/0"][:, 0].cpu().numpy()

            if self.with_depth and gt_depth is not None:
                for i in range(n_b):
                    m = depth_metrics_single(disp[i], gt_depth[i], stereo) if valid[i] else None
                    for k, v in (m or {}).items():
                        upd(k, v)

            if not self.with_layout:
                continue
            for key, label, prefix, types in (("topview", "bev_static", "road", _ROAD_TYPES),
                                              ("topviewB", "bev_dynamic", "vehicle",
                                               _VEHICLE_TYPES)):
                # A branch the model does not have (skip_inactive_branch) is absent.
                if model_type not in types or key not in out:
                    continue
                pred = out[key].argmax(1).cpu().numpy()
                gt = np.asarray(batch[label]).astype(np.int64)
                for i in range(n_b):
                    if not valid[i]:
                        continue
                    iou, prec = mean_iu(pred[i], gt[i]), mean_precision(pred[i], gt[i])
                    # A single-class label has no class-1 score: skipped.
                    if len(iou) > 1 and len(prec) > 1:
                        upd(f"{prefix}_iou", iou[1])
                        upd(f"{prefix}_map", prec[1])

        summary = {k: m.avg for k, m in meters.items()}
        if dist.is_distributed():
            sums = [[meters[k].sum if k in meters else 0.0 for k in SUM_KEYS] + [n_valid],
                    [meters[k].count if k in meters else 0 for k in SUM_KEYS] + [1]]
            tot = dist.global_sum(torch.tensor(sums, dtype=torch.float64,
                                               device=self.device)).cpu()
            summary = {k: float(tot[0, i] / tot[1, i])
                       for i, k in enumerate(SUM_KEYS) if tot[1, i] > 0}
            n_valid = int(tot[0, -1])
        # Every dataset sample is evaluated once: the loader pads the tail
        # and marks the pads invalid, so this equals len(dataset).
        summary["n_eval_samples"] = n_valid
        if fwd_time > 0:
            summary["fps"] = n_imgs / fwd_time
        return summary
