"""Rank-0 JSON-lines training logger (counterpart of
`jperceiver_tpu/engine/logger.py`): scalar metrics go to the log and, one
JSON object a line, to `<work_dir>/<stamp>.log.json`. Only rank 0 writes;
the rank is `torch.distributed`'s when it is initialised, else 0."""

from __future__ import annotations

import json
import logging
import os
import time

import torch


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_root_logger(log_level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("jperceiver_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(h)
    logger.setLevel(log_level if _rank() == 0 else logging.ERROR)
    return logger


class JsonLogger:
    """A `log_fn` for `Trainer`: appends each payload to the log file and
    logs the first six float metrics of train and val payloads."""

    def __init__(self, work_dir: str, stamp: str | None = None):
        self.is_main = _rank() == 0
        self.path = None
        if self.is_main:
            os.makedirs(work_dir, exist_ok=True)
            stamp = stamp or time.strftime("%Y%m%d_%H%M%S")
            self.path = os.path.join(work_dir, f"{stamp}.log.json")
        self.logger = get_root_logger()

    def __call__(self, payload: dict) -> None:
        if not self.is_main:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(payload, default=float) + "\n")
        if payload.get("mode") in ("train", "val"):
            keys = [k for k in payload if k not in ("mode", "epoch", "iter")]
            head = ", ".join(f"{k}={payload[k]:.4f}" for k in keys[:6]
                             if isinstance(payload[k], float))
            self.logger.info("%s epoch %s iter %s: %s", payload["mode"],
                             payload.get("epoch"), payload.get("iter"), head)
