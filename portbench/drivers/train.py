"""Training traffic: the captured training step (`engine/trainer.py::
make_train_step`, the step `Trainer.fit` calls) run back to back on
batches cycled from a pool resident on the device.

Traffic keys: `batch` (rows a step), `pool` (distinct batches),
`steps_per_epoch` (where the LR milestones fall), `trace_after` and
`trace_steps` (the traced slice of the window).

Set-up builds the step once and drives it through its first steps on
pool batches 0, 1, 2 (an eager step, the capture, a replay): the steps
the reference follows. The window goes on with the same step object.
"""

from __future__ import annotations

import torch

from portbench import compare, data
from portbench.reference import train as ref

COMPARED_STEPS = 3


class Driver:
    def __init__(self, ctx):
        from jperceiver_tpu_torch.engine import make_train_step
        from jperceiver_tpu_torch.models import build_model

        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        self.batch = int(t["batch"])
        dev = ctx.device
        model = build_model(dict(cfg["model"]))
        model.load_state_dict(data.model_weights(cfg["model"], ctx.seed, dev), strict=True)
        self.gen_seed = data.stream_seed(ctx.seed, 4)
        self.step_fn = make_train_step(model.to(dev), cfg["model"], dev,
                                       steps_per_epoch=int(t["steps_per_epoch"]),
                                       seed=self.gen_seed, optim_cfg=cfg)
        self.pool = [data.train_batch(cfg["model"], self.batch, ctx.seed, i, dev)
                     for i in range(int(t["pool"]))]
        self.done = 0
        self.readings = self._first_steps()

    def _first_steps(self) -> dict:
        """The compared steps, through the window's own call: each step's
        loss, step 1's outputs, the gradient norms Adam got at step 1 (its
        first moment over 1 - b1) and each parameter's distance from its
        start after them."""
        step = self.step_fn
        names = [n for n, p in step.model.named_parameters() if p.requires_grad]
        out = {"loss": [], "grad": None, "change": None, "outputs": None}
        seen = {}
        keys = ref.first_output_keys(self.ctx.cfg["model"]["frame_ids"])
        hook = step.model.register_forward_hook(
            lambda mod, args, outputs: seen.update(
                {k: outputs[k].detach().clone() for k in keys}))
        for i in range(COMPARED_STEPS):
            metrics = step(self.pool[self.done % len(self.pool)])
            self.done += 1
            if i == 0:
                hook.remove()
                out["outputs"] = {k: v.cpu() for k, v in seen.items()}
            out["loss"].append(float(metrics["loss"]))
            if i == 0:
                b1 = step.optimizer.betas[0]
                state = [step.optimizer.state.get(p, {}) for p in step.params]
                out["grad"] = {n: float(st["mu"].float().norm()) / (1 - b1) if "mu" in st
                               else 0.0 for n, st in zip(names, state)}
        start = data.model_weights(self.ctx.cfg["model"], self.ctx.seed, self.ctx.device)
        with torch.no_grad():
            out["change"] = {n: float((p - start[n]).norm())
                             for n, p in step.model.named_parameters() if p.requires_grad}
        return out

    def step(self) -> dict:
        self.step_fn(self.pool[self.done % len(self.pool)])
        self.done += 1
        return {"frames": self.batch}

    def end_to_end(self, window: dict) -> dict:
        return {"train_frames_per_s": window["frames"] / window["seconds"]}

    def flops_pass(self) -> dict:
        return {"mode": "train", "batch": self.batch}

    def free(self):
        self.step_fn = None

    def _model(self):
        cfg, dev = self.ctx.cfg, self.ctx.device
        return ref.build(cfg["model"], data.model_weights(cfg["model"], self.ctx.seed, dev),
                         dev, remat=dev.type == "cuda")

    def _reference(self, control: str | None = None) -> dict:
        """The reference's readings over the same first steps, from the same
        weights and batches (fp32, TF32 off; `control` its precision)."""
        from portbench.reference.model import precision

        batches = [self.pool[i % len(self.pool)] for i in range(COMPARED_STEPS)]
        with precision(control):
            return ref.train_readings(self._model(), self.ctx.cfg, batches, self.gen_seed,
                                      self.ctx.device)

    def numbers(self, control: str | None = None) -> dict:
        """The program's numbers against the reference, or with `control`
        the reference's own in that precision."""
        from portbench.reference.model import precision

        if getattr(self, "_ref", None) is None:
            self._ref = self._reference()
            with precision("tf32"):
                self._unit = ref.first_outputs(self._model(), self.pool[0], self.gen_seed)
        side = self.readings if control is None else self._reference(control)
        return compare.train_numbers(side, self._ref, self._unit)
