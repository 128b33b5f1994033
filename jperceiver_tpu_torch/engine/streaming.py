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
from ..ops.geometry import se3_compose, se3_inverse


def make_streaming_fn(model, chunk: int = 8, device=None) -> Callable:
    """Returns `run(frames, init_pose=None) -> dict` for frames (T, 3, H, W)
    in [0, 1] (a tensor or numpy array). Every output has T-1 entries, one
    per frame after the first: `disp` (T-1, 1, H/2, W/2), `topview` and
    `topviewB` where the model has that branch, `cam_T_cam` and
    `global_pose` (T-1, 4, 4). `cam_T_cam` is in the compute dtype, as
    `pose_between` gives it; `global_pose` is fp32. Every call runs the
    model in eval mode, whatever mode a training step between calls left.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def run(frames, init_pose=None) -> dict[str, torch.Tensor]:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        gpose = (torch.eye(4, dtype=torch.float32, device=dev)
                 if init_pose is None else
                 torch.as_tensor(init_pose, dtype=torch.float32, device=dev))
        outs: dict[str, list[torch.Tensor]] = {}
        model.eval()
        with torch.inference_mode():
            prev = frames[:1]
            for start in range(1, frames.shape[0], chunk):
                seg = frames[start:start + chunk]
                prevs = torch.cat([prev, seg[:-1]], 0)
                out = model({"color_aug": seg[:, None]}, with_pose=False)
                poses = model.pose_between(prevs, seg)
                chained = []
                for t in poses:
                    gpose = se3_compose(gpose[None], se3_inverse(t[None]))[0]
                    chained.append(gpose)
                ys = {"disp": out["disp/0"], "cam_T_cam": poses,
                      "global_pose": torch.stack(chained)}
                for key in ("topview", "topviewB"):
                    if key in out:
                        ys[key] = out[key]
                for k, v in ys.items():
                    outs.setdefault(k, []).append(v)
                prev = seg[-1:]
        return {k: torch.cat(v, 0) for k, v in outs.items()}

    return run
