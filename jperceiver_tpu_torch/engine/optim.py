"""Optimizer and LR schedule (counterpart of `jperceiver_tpu/engine/optim.py`).

The reference recipe: Adam (AdamW when weight decay is set, as optax's
`adamw`), global-norm gradient clip (`clip_by_global_norm`), the step LR
policy with an optional linear warmup, per iteration. `Adam` and `SGD`
compute optax's updates in optax's order with the learning rate and the
step count on the device (`_DeviceLR`), so that the step can be captured as
a CUDA graph; the clip and the schedule follow optax and mmcv exactly.

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


class _DeviceLR(torch.optim.Optimizer):
    """An optimizer whose learning rates and step counts live on the
    parameters' device, so that a captured step (`engine/graphs.py`) reads
    them anew at every replay: each group's `lr` is a 0-d tensor in its
    parameters' dtype, which `set_lr` fills before each step, and the counts
    are device tensors that the step itself advances. No step reads a value
    back to the host.

    `load_state_dict` takes the state dicts this optimizer writes and those
    that the port's earlier optimizers wrote (`torch.optim.Adam` /
    `AdamW` / `SGD`, a host-side count, a float `lr`): `_RENAMED` maps
    their state keys to this optimizer's."""

    _RENAMED: dict[str, str] = {}

    def __init__(self, params, defaults: dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            group["lr"] = self._lr_tensor(group, group["lr"])

    @staticmethod
    def _lr_tensor(group: dict, value):
        if not group["params"]:  # a ZeRO-1 rank's empty share: nothing reads it
            return value
        p = group["params"][0]
        return torch.full((), float(value), dtype=p.dtype, device=p.device)

    def _state_tensor(self, p: torch.nn.Parameter, key: str, value: torch.Tensor):
        return value.to(device=p.device, dtype=p.dtype)

    def load_state_dict(self, state_dict: dict) -> None:
        lrs = [g["lr"] for g in self.param_groups]
        super().load_state_dict(state_dict)
        for group, lr in zip(self.param_groups, lrs):
            saved = group["lr"]
            group["lr"] = lr
            if isinstance(lr, torch.Tensor):
                lr.fill_(float(saved))
            else:
                group["lr"] = float(saved)
        for p, st in self.state.items():
            for old, new in self._RENAMED.items():
                if old in st:
                    st[new] = st.pop(old)
            for k, v in list(st.items()):
                if k == "step":
                    st[k] = torch.full((), float(v), dtype=torch.float32, device=p.device)
                elif isinstance(v, torch.Tensor):
                    st[k] = self._state_tensor(p, k, v)


class Adam(_DeviceLR):
    """optax `adam` / `adamw` (`weight_decay` > 0), each step in optax's
    arithmetic and order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
    both divided by their bias corrections 1 - b^count (on the device, in
    the moments' dtype),
    u = mu_hat / (sqrt(nu_hat) + eps) (+ weight_decay * p), p -= lr u.

    `mu_dtype` (optax's) stores the first moment in that dtype: the product
    b1 mu is taken in `mu_dtype` with b1 rounded to it, and mu is rounded to
    it only when it is stored. The second moment keeps the parameter's
    dtype. The state of a parameter is `step` (a 0-d fp32 count on its
    device), `mu` and `nu`."""

    _RENAMED = {"exp_avg": "mu", "exp_avg_sq": "nu"}

    def __init__(self, params, lr: float, weight_decay: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, mu_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.mu_dtype, self.betas, self.eps = mu_dtype, betas, eps
        # b1 as a weak-typed scalar of mu_dtype in JAX: 0.8984375 in bf16.
        self._b1_mu = betas[0] if mu_dtype is None else float(
            torch.tensor(betas[0], dtype=mu_dtype))

    def _state_tensor(self, p, key, value):
        if key == "mu" and self.mu_dtype is not None:
            return value.to(device=p.device, dtype=self.mu_dtype)
        return super()._state_tensor(p, key, value)

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
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype,
                                                memory_format=torch.preserve_format)
                    st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            counts = [st["step"] for st in states]
            torch._foreach_add_(counts, 1.0)
            grads = [p.grad for p in ps]
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, [m.to(g.dtype) for m, g in zip(
                torch._foreach_mul([st["mu"] for st in states], self._b1_mu), grads)])
            nus = [st["nu"] for st in states]
            nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            torch._foreach_add_(nu, torch._foreach_mul(nus, b2))
            count = counts[0].to(mu[0].dtype)
            bc1, bc2 = 1.0 - torch.pow(b1, count), 1.0 - torch.pow(b2, count)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, group["lr"])
            torch._foreach_sub_(ps, upd)
            torch._foreach_copy_([st["mu"] for st in states], mu)
            torch._foreach_copy_(nus, nu)
        return None


class AdamLowPrecisionMu(Adam):
    """`Adam` with its first moment stored in `mu_dtype` (optax's
    `mu_dtype`), the optimizer of `optimizer.mu_dtype`."""

    def __init__(self, params, lr: float, mu_dtype: torch.dtype, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr, weight_decay, betas, eps, mu_dtype=mu_dtype)


class SGD(_DeviceLR):
    """optax `sgd` with `momentum` (no Nesterov): t = g + momentum t,
    p -= lr t; without momentum p -= lr g. The trace is the state's
    `momentum_buffer`."""

    def __init__(self, params, lr: float, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr))
        self.momentum = momentum

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            trace = [p.grad for p in ps]
            if self.momentum:
                for p in ps:
                    if "momentum_buffer" not in self.state[p]:
                        self.state[p]["momentum_buffer"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                trace = [self.state[p]["momentum_buffer"] for p in ps]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, [p.grad for p in ps])
            torch._foreach_sub_(ps, torch._foreach_mul(trace, group["lr"]))
        return None


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int, labels: Sequence[str] | None = None,
                    zero1: bool = False):
    """cfg -> (optimizer, schedule, clip max-norm or None). The optimizer's
    lr is set from the schedule before each step by the caller
    (`set_lr`). `labels`, one per parameter in order (`param_labels`), is
    needed when `optimizer.paramwise_options` is set: the biases labelled
    "bias" then go to a group whose `lr_mult` is `bias_lr_mult`.

    `zero1` (the JAX package's `zero1_state_shardings`, turned on there by
    an argument too) wraps the optimizer in `ZeroRedundancyOptimizer`: each
    rank keeps the moments of its share of the parameters, updates those
    and broadcasts them. The groups and their `lr_mult` are kept; `set_lr`
    sets the wrapper's groups, which it hands on at each step."""
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
            cls, kw = AdamLowPrecisionMu, dict(
                lr=sched(0), weight_decay=wd,
                mu_dtype=getattr(torch, mu_dtype) if isinstance(mu_dtype, str) else mu_dtype)
        else:
            cls, kw = Adam, dict(lr=sched(0), weight_decay=wd, eps=1e-8)
    elif opt_type == "sgd":
        cls, kw = SGD, dict(lr=sched(0), momentum=float(opt_cfg.get("momentum", 0.9)))
    else:
        raise ValueError(f"unsupported optimizer: {opt_type}")
    if zero1:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        from ..parallel import is_distributed

        if not is_distributed():
            raise ValueError("zero1 shards the optimizer state over a process group; "
                             "there is none (init_distributed)")
        opt = ZeroRedundancyOptimizer(groups, optimizer_class=cls, **kw)
    else:
        opt = cls(groups, **kw)
    clip = None
    oc = cfg.get("optimizer_config", None)
    if oc and oc.get("grad_clip"):
        clip = float(oc["grad_clip"].get("max_norm", 35.0))
    return opt, sched, clip


def set_lr(opt: torch.optim.Optimizer, sched: Callable[[int], float], it: int) -> None:
    """Each group's lr at iteration `it`: the schedule's times the group's
    `lr_mult`, filled into the group's lr tensor on the device (a fill, no
    copy from the host: a captured step reads it at its next replay), or
    set as a float where a group holds one."""
    for group in opt.param_groups:
        lr = sched(it) * group.get("lr_mult", 1.0)
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax `clip_by_global_norm`: g * min(1, max_norm / norm), in place;
    no host synchronisation."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
