"""Optimizer and LR schedule (counterpart of `jperceiver_tpu/engine/optim.py`).

The reference recipe: Adam (AdamW when weight decay is set, as optax's
`adamw`), global-norm gradient clip (`clip_by_global_norm`), the step LR
policy with an optional linear warmup, per iteration. `torch.optim.Adam`
and `AdamW` compute optax's update (bias-corrected moments, eps outside the
square root, decoupled decay), so they are used as they are; the clip and
the schedule follow optax and mmcv exactly.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """`lr_config` -> lr at an iteration. `policy` "step" multiplies the lr
    by `gamma` (0.1) at each epoch milestone of `step`; "fixed" keeps it.
    `warmup` "linear" scales the lr at iteration i by
    1 - (1 - min(i, warmup_iters) / warmup_iters) * (1 - warmup_ratio),
    mmcv's rule: the milestones stay at their absolute iterations."""
    base_lr = float(cfg.get("learning_rate", cfg.get("lr", 1e-4)))
    lr_cfg = cfg.get("lr_config", None) or {}
    policy = lr_cfg.get("policy", "fixed")
    if policy == "step":
        gamma = float(lr_cfg.get("gamma", 0.1))
        milestones = [int(e) * steps_per_epoch for e in lr_cfg.get("step", [])]
    elif policy == "fixed":
        gamma, milestones = 1.0, []
    else:
        raise ValueError(f"unsupported lr policy: {policy}")
    warmup = lr_cfg.get("warmup", None) == "linear"
    wi = int(lr_cfg.get("warmup_iters", 500))
    ratio = float(lr_cfg.get("warmup_ratio", 1.0 / 3))

    def sched(step: int) -> float:
        # optax.piecewise_constant_schedule: the scale applies from the
        # boundary's own iteration on.
        lr = base_lr * gamma ** sum(step >= m for m in milestones)
        if warmup:
            lr *= 1.0 - (1.0 - min(step, wi) / wi) * (1.0 - ratio)
        return lr

    return sched


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int):
    """cfg -> (optimizer, schedule, clip max-norm or None). The optimizer's
    lr is set from the schedule before each step by the caller."""
    opt_cfg = cfg.get("optimizer", None) or {"type": "Adam", "lr": 1e-4}
    opt_type = opt_cfg.get("type", "Adam").lower()
    wd = float(opt_cfg.get("weight_decay", 0.0))
    sched = build_lr_schedule({"learning_rate": opt_cfg.get("lr", 1e-4),
                               "lr_config": cfg.get("lr_config", None)},
                              steps_per_epoch)
    params = list(params)
    if opt_type == "adam":
        # optax.adam / adamw defaults: b1 0.9, b2 0.999, eps 1e-8.
        opt = (torch.optim.AdamW(params, lr=sched(0), weight_decay=wd, eps=1e-8)
               if wd else torch.optim.Adam(params, lr=sched(0), eps=1e-8))
    elif opt_type == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0),
                              momentum=float(opt_cfg.get("momentum", 0.9)))
    else:
        raise ValueError(f"unsupported optimizer: {opt_type}")
    clip = None
    oc = cfg.get("optimizer_config", None)
    if oc and oc.get("grad_clip"):
        clip = float(oc["grad_clip"].get("max_norm", 35.0))
    return opt, sched, clip


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax `clip_by_global_norm`: g * min(1, max_norm / norm), in place;
    no host synchronisation."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
