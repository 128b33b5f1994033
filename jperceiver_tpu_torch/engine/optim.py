"""Optimizer and LR schedule (counterpart of `jperceiver_tpu/engine/optim.py`).

The reference recipe: Adam (AdamW when weight decay is set, as optax's
`adamw`), global-norm gradient clip (`clip_by_global_norm`), the step LR
policy with an optional linear warmup, per iteration. `torch.optim.Adam`
and `AdamW` compute optax's update (bias-corrected moments, eps outside the
square root, decoupled decay), so they are used as they are; the clip and
the schedule follow optax and mmcv exactly.

Two knobs of `optimizer` follow the JAX package too: `mu_dtype` stores
Adam's first moment in that dtype (`AdamLowPrecisionMu`, optax's
`mu_dtype`), and `paramwise_options.bias_lr_mult` scales the updates of
the biases that are not normalisation parameters (`param_labels`, the
labels of the JAX package's `_label_params`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch
import torch.nn as nn


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


_NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)


def param_labels(model: nn.Module) -> dict[str, str]:
    """Each trainable parameter's label, as `jperceiver_tpu/engine/optim.py::
    _label_params` gives it on the flax tree: "norm" for the scale and bias
    of a normalisation layer, "bias" for any other bias, else "default".
    The JAX package matches `bn|norm|batchnorm` in the flax path; the port's
    names follow the reference keys (a layout decoder's norms are list
    indices), so the port reads the layer's type instead."""
    labels = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if p.requires_grad:
                label = ("norm" if isinstance(module, _NORMS)
                         else "bias" if pname == "bias" else "default")
                labels[f"{mname}.{pname}" if mname else pname] = label
    return labels


class AdamLowPrecisionMu(torch.optim.Optimizer):
    """optax `adam` / `adamw` with `mu_dtype`: the first moment is kept in
    `mu_dtype`, the second in the parameter's dtype. Each step follows
    optax's arithmetic in its order: mu = (1 - b1) g + b1 mu (the product
    b1 mu in `mu_dtype`, with b1 rounded to it), nu = (1 - b2) g^2 + b2 nu, both bias-corrected,
    u = mu_hat / (sqrt(nu_hat) + eps) (+ weight_decay * p), p += -lr u,
    with mu rounded to `mu_dtype` only when it is stored."""

    def __init__(self, params, lr: float, mu_dtype: torch.dtype,
                 weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.mu_dtype, self.betas, self.eps = mu_dtype, betas, eps

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.betas
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            states = [self.state[p] for p in ps]
            for p, st in zip(ps, states):
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype,
                                                memory_format=torch.preserve_format)
                    st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["step"] += 1
            grads = [p.grad for p in ps]
            mu = torch._foreach_mul(grads, 1 - b1)
            # b1 * mu is a product in mu_dtype, b1 rounded to it first (a
            # weak-typed scalar in JAX): 0.8984375 in bf16.
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            torch._foreach_add_(mu, [m.to(g.dtype) for m, g in zip(
                torch._foreach_mul([st["mu"] for st in states], b1_mu), grads)])
            nus = [st["nu"] for st in states]
            nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nus, b2))
            count = states[0]["step"]
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2.item()))
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1.item()), den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(ps, upd)
            for st, m, n in zip(states, mu, nu):
                st["mu"].copy_(m)
                st["nu"].copy_(n)
        return None


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int, labels: Sequence[str] | None = None):
    """cfg -> (optimizer, schedule, clip max-norm or None). The optimizer's
    lr is set from the schedule before each step by the caller
    (`set_lr`). `labels`, one per parameter in order (`param_labels`), is
    needed when `optimizer.paramwise_options` is set: the biases labelled
    "bias" then go to a group whose `lr_mult` is `bias_lr_mult`."""
    opt_cfg = cfg.get("optimizer", None) or {"type": "Adam", "lr": 1e-4}
    opt_type = opt_cfg.get("type", "Adam").lower()
    wd = float(opt_cfg.get("weight_decay", 0.0))
    sched = build_lr_schedule({"learning_rate": opt_cfg.get("lr", 1e-4),
                               "lr_config": cfg.get("lr_config", None)},
                              steps_per_epoch)
    params = list(params)
    groups = [{"params": params, "lr_mult": 1.0}]
    pw = opt_cfg.get("paramwise_options", None)
    if pw:
        if labels is None or len(labels) != len(params):
            raise ValueError("optimizer.paramwise_options needs one label per parameter")
        mult = float(pw.get("bias_lr_mult", 1.0))
        groups = [{"params": [p for p, lb in zip(params, labels) if lb != "bias"],
                   "lr_mult": 1.0},
                  {"params": [p for p, lb in zip(params, labels) if lb == "bias"],
                   "lr_mult": mult}]
        groups = [g for g in groups if g["params"]]
    mu_dtype = opt_cfg.get("mu_dtype", None)
    if opt_type == "adam":
        # optax.adam / adamw defaults: b1 0.9, b2 0.999, eps 1e-8.
        if mu_dtype is not None:
            opt = AdamLowPrecisionMu(groups, sched(0), getattr(torch, mu_dtype)
                                     if isinstance(mu_dtype, str) else mu_dtype,
                                     weight_decay=wd)
        elif wd:
            opt = torch.optim.AdamW(groups, lr=sched(0), weight_decay=wd, eps=1e-8)
        else:
            opt = torch.optim.Adam(groups, lr=sched(0), eps=1e-8)
    elif opt_type == "sgd":
        opt = torch.optim.SGD(groups, lr=sched(0),
                              momentum=float(opt_cfg.get("momentum", 0.9)))
    else:
        raise ValueError(f"unsupported optimizer: {opt_type}")
    clip = None
    oc = cfg.get("optimizer_config", None)
    if oc and oc.get("grad_clip"):
        clip = float(oc["grad_clip"].get("max_norm", 35.0))
    return opt, sched, clip


def set_lr(opt: torch.optim.Optimizer, sched: Callable[[int], float], it: int) -> None:
    """Each group's lr at iteration `it`: the schedule's times the group's
    `lr_mult`."""
    for group in opt.param_groups:
        group["lr"] = sched(it) * group.get("lr_mult", 1.0)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax `clip_by_global_norm`: g * min(1, max_norm / norm), in place;
    no host synchronisation."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
