"""Streaming video inference (counterpart of
`jperceiver_tpu/engine/streaming.py`).

The JAX `lax.scan` over frames becomes a loop over chunks of `chunk`
frames: the depth, layout and pose networks run on a whole chunk at once
(they need no carry), and the carry (previous frame, global pose) is
chained frame by frame. Outputs per frame: disparity, road/vehicle layouts,
the frame-to-frame transform and the chained global pose
(`global @= inv(T)`).
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..models.common import kernel_gates
from ..ops.geometry import se3_compose, se3_inverse
from ..tracing import mark, span
from .graphs import GraphCache, tensor_key, use_graphs


def make_streaming_fn(model, chunk: int = 8, device=None, graph: bool | None = None) -> Callable:
    """Returns `run(frames, init_pose=None) -> dict` for frames (T, 3, H, W)
    in [0, 1] (a tensor or numpy array). Every output has T-1 entries, one
    per frame after the first: `disp` (T-1, 1, H/2, W/2), `topview` and
    `topviewB` where the model has that branch, `cam_T_cam` and
    `global_pose` (T-1, 4, 4). `cam_T_cam` is in the compute dtype, as
    `pose_between` gives it; `global_pose` is fp32. Every call runs the
    model in eval mode, whatever mode a training step between calls left.

    `graph` (JAX's `jit` of the scan, `engine/graphs.py`): None captures a
    chunk as a CUDA graph, one a chunk length, on CUDA (under a process
    group too: a chunk has no collective); False runs it eagerly; True
    captures or raises. The carry (the previous frame and the global pose)
    lives in tensors that every chunk's graph reads and writes in place, as
    the scan carries it. The outputs `run` returns are its own, not a
    graph's.

    A call is the span `stream`; device marks `chunk` and `end` bound each
    chunk's body (`tracing.py`).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    graphed = use_graphs(graph, dev, "make_streaming_fn", collectives=False)
    gates = kernel_gates(model)
    carries: dict = {}

    def step(seg, prev, gpose) -> dict[str, torch.Tensor]:
        """One chunk: the batched forward, the pose of each frame against
        the one before, and the global pose chained frame by frame; the
        carry updated in place."""
        mark("chunk", seg.device)
        prevs = torch.cat([prev, seg[:-1]], 0)
        out = model({"color_aug": seg[:, None]}, with_pose=False)
        poses = model.pose_between(prevs, seg)
        g, chained = gpose, []
        for t in poses:
            g = se3_compose(g[None], se3_inverse(t[None]))[0]
            chained.append(g)
        ys = {"disp": out["disp/0"], "cam_T_cam": poses, "global_pose": torch.stack(chained)}
        for key in ("topview", "topviewB"):
            if key in out:
                ys[key] = out[key]
        prev.copy_(seg[-1:])
        gpose.copy_(g)
        mark("end", seg.device)
        return ys

    graphs = GraphCache(step, "a streaming chunk")

    def run(frames, init_pose=None) -> dict[str, torch.Tensor]:
        model.eval()
        with span("stream"), torch.inference_mode():
            frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
            size = tuple(frames.shape[1:])
            if size not in carries:
                carries[size] = {"prev": torch.empty((1, *size), device=dev),
                                 "gpose": torch.empty((4, 4), device=dev)}
            carry = carries[size]
            carry["prev"].copy_(frames[:1])
            if init_pose is None:
                carry["gpose"].copy_(torch.eye(4, dtype=torch.float32, device=dev))
            else:
                carry["gpose"].copy_(torch.as_tensor(init_pose, dtype=torch.float32))
            n = frames.shape[0] - 1
            outs: dict[str, torch.Tensor] = {}
            for start in range(1, frames.shape[0], chunk):
                inputs = {"seg": frames[start:start + chunk]}
                if graphed:
                    ys = graphs.run((tensor_key(inputs), gates()), inputs, carry)
                else:
                    ys = step(**inputs, **carry)
                for k, v in ys.items():
                    if k not in outs:
                        outs[k] = torch.empty((n, *v.shape[1:]), dtype=v.dtype, device=dev)
                    outs[k][start - 1:start - 1 + v.shape[0]].copy_(v)
        return outs

    run.graphs = graphs
    return run
