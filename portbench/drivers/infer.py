"""Serving traffic: one client in a closed loop calls the captured eval
step (`engine/infer.py::make_eval_step`, every output, with pose).

Traffic keys: `batch` (frames a request), `pool` (distinct requests, each
(batch, F, 3, H, W) fp32 in pinned host memory), `outputs` (the outputs a
request waits for on the host), `sample` (requests kept for the check),
`trace_after` and `trace_steps`.

A request is timed from the host frames handed to the eval step until
its outputs are on the host. The check compares a sample of the window's
requests, drawn from the seed (reservoir sampling over all of them),
with the reference's outputs on the same frames.
"""

from __future__ import annotations

import random
import statistics

from portbench import compare, data
from portbench.reference import train as ref

GROUPS = {"disp": ["disp/0"], "layout": ["topview", "topviewB"],
          "pose": ["cam_T_cam/-1", "cam_T_cam/1"]}  # keys the reference lacks are skipped


class Driver:
    def __init__(self, ctx):
        from jperceiver_tpu_torch.engine import make_eval_step
        from jperceiver_tpu_torch.models import build_model

        self.ctx = ctx
        cfg, t, dev = ctx.cfg, ctx.traffic, ctx.device
        self.batch = int(t["batch"])
        self.keys = list(t["outputs"])
        model = build_model(dict(cfg["model"]))
        model.load_state_dict(self._weights(), strict=True)
        self.step_fn = make_eval_step(model.to(dev), cfg["model"], dev)
        m = cfg["model"]
        shape = (self.batch, len(m["frame_ids"]), 3, m["height"], m["width"])
        pin = dev.type == "cuda"
        self.pool = []
        for i in range(int(t["pool"])):
            aug = data.frames(shape, ctx.seed, i, dev)[1].cpu()
            self.pool.append(aug.pin_memory() if pin else aug)
        self.rng = random.Random(data.stream_seed(ctx.seed, 5))
        self.sample_size = int(t["sample"])
        self.sample: list = []
        self.latencies: list[float] = []
        self.done = 0
        # Warm-up: the eager call and the capture of this request shape.
        for _ in range(2):
            self._request(self.done % len(self.pool))
            self.done += 1

    def _request(self, i: int) -> dict:
        out = self.step_fn({"color_aug": self.pool[i]})
        return {k: out[k].cpu() for k in self.keys}

    def _weights(self) -> dict:
        return data.model_weights(self.ctx.cfg["model"], self.ctx.seed, self.ctx.device)

    def step(self) -> dict:
        import time

        i = self.done % len(self.pool)
        t0 = time.perf_counter()
        host = self._request(i)
        self.latencies.append(time.perf_counter() - t0)
        self.done += 1
        n = len(self.latencies)
        if len(self.sample) < self.sample_size:
            self.sample.append((i, host))
        else:
            j = self.rng.randrange(n)
            if j < self.sample_size:
                self.sample[j] = (i, host)
        return {"frames": self.batch}

    def end_to_end(self, window: dict) -> dict:
        ms = [1e3 * s for s in self.latencies]
        p95 = statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else ms[0]
        return {"infer_ms_p50": statistics.median(ms), "infer_ms_p95": p95}

    def flops_pass(self) -> dict:
        return {"mode": "eval", "batch": self.batch}

    def free(self):
        self.step_fn = None

    def numbers(self, control: str | None = None) -> dict:
        from portbench.reference.model import precision

        cfg, dev = self.ctx.cfg, self.ctx.device
        model = ref.build(cfg["model"], self._weights(), dev)
        triples = []
        for i, host in self.sample:
            frames = self.pool[i].to(dev)
            want = ref.eval_outputs(model, frames)
            with precision("tf32"):
                unit = ref.eval_outputs(model, frames)
            if control is not None:
                with precision(control):
                    host = ref.eval_outputs(model, frames)
            triples.append((host, want, unit))
        return compare.output_numbers(triples, GROUPS)
