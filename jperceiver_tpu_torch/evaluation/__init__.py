"""Evaluation for the port: depth and layout metrics, pose files and
trajectory alignment, rotation conversions and the KITTI odometry protocol
(the port's own copy of `jperceiver_tpu/evaluation/`; numpy only)."""

from .metrics import AverageMeter, compute_depth_errors, confusion_counts, mean_iu, mean_precision

__all__ = ["AverageMeter", "compute_depth_errors", "confusion_counts", "mean_iu",
           "mean_precision"]
