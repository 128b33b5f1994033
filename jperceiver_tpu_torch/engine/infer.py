"""The eval step (counterpart of `jperceiver_tpu/engine/trainer.py::
make_eval_step`): every output including pose, eval-mode BatchNorm, no
losses."""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..models.common import kernel_gates, set_kernels
from ..tracing import mark, span
from .graphs import GraphCache, tensor_key, use_graphs


def conv_gates_from_cfg(cfg=None) -> tuple[bool, bool]:
    """K3's (shallow, deep) gates from the JAX package's config keys
    `use_pallas_conv` and `use_pallas_conv_deep`. A key that is absent or
    None leaves its gate on: on the H100 the kernel is the port of the TPU
    kernel, and the JAX package's TPU defaults do not carry over."""
    get = getattr(cfg, "get", lambda key: None)
    values = (get("use_pallas_conv"), get("use_pallas_conv_deep"))
    shallow, deep = (True if v is None else bool(v) for v in values)
    return shallow, deep


def make_eval_step(model, cfg=None, device=None, graph: bool | None = None
                   ) -> Callable[[dict], dict]:
    """Returns `step(batch) -> outputs`: the model in eval mode on `device`
    (CUDA by default), run under `torch.inference_mode()` with pose. Every
    call puts the model in eval mode first, so a step built once runs on the
    running statistics, without dropout, after any training step between
    its calls.

    batch["color_aug"] is (B, F, 3, H, W) in [0, 1], a tensor or a numpy
    array; outputs are float32 tensors on `device` (see `models/jperceiver`).

    `graph` (JAX's `jit`, `engine/graphs.py`): None captures the forward as
    a CUDA graph an input shape on CUDA (under a process group too: the
    forward has no collective), False runs it eagerly, True captures or
    raises. A captured step returns its graph's static outputs, which the
    next call at that shape writes over.
    The graph reads the model's parameters and statistics where they are,
    so it sees every training step between calls.

    A call is the span `eval_step` with `eval_step.upload` (the frames to
    the device) and the graph's spans inside; device marks `eval` and
    `end` bound the forward (`tracing.py`).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    set_kernels(model, *conv_gates_from_cfg(cfg))
    graphed = use_graphs(graph, dev, "make_eval_step", collectives=False)
    gates = kernel_gates(model)

    def forward(color_aug):
        with torch.inference_mode():
            mark("eval", dev)
            out = model({"color_aug": color_aug}, train=False, with_pose=True)
            mark("end", dev)
            return out

    graphs = GraphCache(forward, "the eval step")

    def step(batch: dict) -> dict[str, torch.Tensor]:
        with span("eval_step"):
            with span("eval_step.upload"):
                color_aug = torch.as_tensor(batch["color_aug"], dtype=torch.float32,
                                            device=dev)
            if not graphed:
                return forward(color_aug)
            model.eval()  # the mode the eager forward leaves
            inputs = {"color_aug": color_aug}
            return graphs.run((tensor_key(inputs), gates()), inputs)

    step.graphs = graphs
    return step
