"""Video traffic: repeated calls of streaming's `run`
(`engine/streaming.py::make_streaming_fn`) over one clip held in pageable
host memory as fp32, as a video reader hands it over; pose chained across
the clip.

Traffic keys: `clip_frames` (frames of the clip; a call outputs one less),
`chunk` (frames a batched forward), `trace_after` and `trace_steps`.

A call is complete when its outputs are on the device and the device has
finished. The check compares the last call's outputs, every frame, with
the reference's over the same clip.
"""

from __future__ import annotations

import torch

from portbench import compare, data
from portbench.reference import train as ref

GROUPS = {"disp": ["disp"], "layout": ["topview", "topviewB"], "pose": ["cam_T_cam"],
          "global_pose": ["global_pose"]}


class Driver:
    def __init__(self, ctx):
        from jperceiver_tpu_torch.engine.streaming import make_streaming_fn
        from jperceiver_tpu_torch.models import build_model

        self.ctx = ctx
        cfg, t, dev = ctx.cfg, ctx.traffic, ctx.device
        m = cfg["model"]
        self.chunk = int(t["chunk"])
        model = build_model(dict(m))
        model.load_state_dict(self._weights(), strict=True)
        self.run = make_streaming_fn(model.to(dev), chunk=self.chunk, device=dev)
        shape = (int(t["clip_frames"]), 3, m["height"], m["width"])
        self.clip = data.frames(shape, ctx.seed, 0, dev)[1].cpu()
        self.sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        self.last = None
        # Warm-up: the eager call and the capture of each chunk length.
        for _ in range(2):
            self.step()

    def _weights(self) -> dict:
        return data.model_weights(self.ctx.cfg["model"], self.ctx.seed, self.ctx.device)

    def step(self) -> dict:
        self.last = self.run(self.clip)
        self.sync()
        return {"frames": self.clip.shape[0] - 1}

    def end_to_end(self, window: dict) -> dict:
        return {"stream_frames_per_s": window["frames"] / window["seconds"]}

    def flops_pass(self) -> dict:
        return {"mode": "stream", "frames": self.clip.shape[0] - 1}

    def free(self):
        self.last = {k: v.cpu() for k, v in self.last.items()}
        self.run = None

    def numbers(self, control: str | None = None) -> dict:
        from portbench.reference.model import precision

        cfg, dev = self.ctx.cfg, self.ctx.device
        model = ref.build(cfg["model"], self._weights(), dev)
        clip = self.clip.to(dev)
        keys = list(self.last)
        want = ref.stream_outputs(model, clip, keys, self.chunk)
        with precision("tf32"):
            unit = ref.stream_outputs(model, clip, keys, self.chunk)
        got = self.last
        if control is not None:
            with precision(control):
                got = ref.stream_outputs(model, clip, keys, self.chunk)
        return compare.output_numbers([(got, want, unit)], GROUPS, {"global_pose": "cam_T_cam"})
