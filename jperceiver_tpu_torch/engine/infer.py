"""The eval step (counterpart of `jperceiver_tpu/engine/trainer.py::
make_eval_step`): every output including pose, eval-mode BatchNorm, no
losses."""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..models.common import set_kernels


def conv_gates_from_cfg(cfg=None) -> tuple[bool, bool]:
    """K3's (shallow, deep) gates from the JAX package's config keys
    `use_pallas_conv` and `use_pallas_conv_deep`. A key that is absent or
    None leaves its gate on: on the H100 the kernel is the port of the TPU
    kernel, and the JAX package's TPU defaults do not carry over."""
    get = getattr(cfg, "get", lambda key: None)
    values = (get("use_pallas_conv"), get("use_pallas_conv_deep"))
    shallow, deep = (True if v is None else bool(v) for v in values)
    return shallow, deep


def make_eval_step(model, cfg=None, device=None) -> Callable[[dict], dict]:
    """Returns `step(batch) -> outputs`: the model in eval mode on `device`
    (CUDA by default), run under `torch.inference_mode()` with pose. Every
    call puts the model in eval mode first, so a step built once runs on the
    running statistics, without dropout, after any training step between
    its calls.

    batch["color_aug"] is (B, F, 3, H, W) in [0, 1], a tensor or a numpy
    array; outputs are float32 tensors on `device` (see `models/jperceiver`).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    set_kernels(model, *conv_gates_from_cfg(cfg))

    def step(batch: dict) -> dict[str, torch.Tensor]:
        color_aug = torch.as_tensor(batch["color_aug"], dtype=torch.float32,
                                    device=dev)
        with torch.inference_mode():
            return model({"color_aug": color_aug}, train=False, with_pose=True)

    return step
