"""The training step (counterpart of `jperceiver_tpu/engine/trainer.py::
make_train_step`): forward in training mode, CGT label, losses, backward,
global-norm clip and the optimizer update, with the BatchNorm running
statistics updated by the forward.

There is no autocast: the model casts to its compute dtype where the JAX
modules do, and the outputs, geometry and losses are fp32.
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..losses.multitask import compute_losses, total_loss
from ..models.common import set_kernels
from .infer import conv_gates_from_cfg
from .optim import build_optimizer, clip_by_global_norm_, global_norm

_LABELS = ("bev_static", "bev_dynamic")


def batch_to(batch: dict, device) -> dict:
    """numpy arrays or tensors -> tensors on `device`: the label maps as
    int64, floating arrays in their own dtype, anything else as fp32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if k in _LABELS else (t if t.is_floating_point() else t.float())
    return out


def make_train_step(model, cfg, device=None, *, steps_per_epoch: int,
                    seed: int = 0) -> Callable[..., dict]:
    """Returns `step(batch, noise=None) -> metrics` for `model` on `device`
    (CUDA by default; raises when there is no card unless the caller asks
    for the CPU).

    Each call runs one step on `batch` (the keys of `data/synthetic.py`,
    numpy or tensors) and returns the loss dict with `loss` (their sum) and
    `grad_norm` (the global norm before the clip), as 0-d tensors on the
    device. The optimizer (cfg `optimizer`, `optimizer_config`,
    `lr_config`, with milestones in epochs of `steps_per_epoch`
    iterations, the length of the caller's loader, as the JAX package's
    `build_optimizer` takes it) lives in the closure. Dropout and the
    automask noise are drawn from one generator on the device seeded with
    `seed`; `noise`
    replaces the automask draw. K3's gates follow the cfg keys
    `use_pallas_conv(_deep)` as in the eval step.
    """
    dev = resolve_device(device)
    model = model.to(dev).train()
    set_kernels(model, *conv_gates_from_cfg(cfg))
    params = [p for p in model.parameters() if p.requires_grad]
    opt, sched, clip = build_optimizer(cfg, params, steps_per_epoch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = 0

    def step(batch: dict, noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        nonlocal it
        batch = batch_to(batch, dev)
        for group in opt.param_groups:
            group["lr"] = sched(it)
        opt.zero_grad(set_to_none=True)
        outputs = model(batch, train=True, generator=gen)
        losses = compute_losses(outputs, batch, cfg, noise=noise, generator=gen)
        loss = total_loss(losses)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        norm = global_norm(grads)
        if clip is not None:
            clip_by_global_norm_(grads, norm, clip)
        opt.step()
        it += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        return metrics

    return step
