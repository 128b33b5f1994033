"""The training step and the epoch loop (counterpart of
`jperceiver_tpu/engine/trainer.py`): `make_train_step` runs one step --
forward in training mode, CGT label, losses, backward, global-norm clip and
the optimizer update, with the BatchNorm running statistics updated by the
forward -- and `Trainer.fit` runs epochs of it over a loader, with a
background prefetch, log payloads, per-epoch callbacks and a profiler
trace.

There is no autocast: the model casts to its compute dtype where the JAX
modules do, and the outputs, geometry and losses are fp32.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import torch

from .._device import resolve_device
from ..losses.multitask import compute_losses, total_loss
from ..models.common import set_kernels
from .infer import conv_gates_from_cfg
from .optim import build_optimizer, clip_by_global_norm_, global_norm, param_labels, set_lr

_LABELS = ("bev_static", "bev_dynamic")
# Steps [start, stop) of the first epoch that `Trainer.fit` traces, as the
# JAX Trainer does.
_PROFILE_STEPS = (10, 15)


def batch_to(batch: dict, device, non_blocking: bool = False) -> dict:
    """numpy arrays or tensors -> tensors on `device`: the label maps as
    int64, floating arrays in their own dtype, anything else as fp32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device, non_blocking=non_blocking)
        out[k] = t.long() if k in _LABELS else (t if t.is_floating_point() else t.float())
    return out


class TrainStep:
    """One training step of `model` on `device`; `make_train_step` builds it.

    Calling it with `batch` (the keys of `data/synthetic.py`, numpy or
    tensors) runs one step and returns the loss dict with `loss` (their sum)
    and `grad_norm` (the global norm before the clip), as 0-d tensors on the
    device. It holds what a checkpoint of the run needs: `model`,
    `optimizer`, `iteration` (steps taken, which the schedule reads) and
    `generator` (dropout and the automask noise).
    """

    def __init__(self, model, cfg, device, steps_per_epoch: int, seed: int, optim_cfg=None):
        self.device = device
        self.model = model.to(device).train()
        self.cfg = cfg
        set_kernels(model, *conv_gates_from_cfg(cfg))
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        labels = param_labels(model)
        self.params = [p for _, p in named]
        self.optimizer, self.schedule, self.clip = build_optimizer(
            cfg if optim_cfg is None else optim_cfg, self.params, steps_per_epoch,
            labels=[labels[n] for n, _ in named])
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.iteration = 0

    def __call__(self, batch: dict, noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        batch = batch_to(batch, self.device)
        set_lr(self.optimizer, self.schedule, self.iteration)
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(batch, train=True, generator=self.generator)
        losses = compute_losses(outputs, batch, self.cfg, noise=noise, generator=self.generator)
        loss = total_loss(losses)
        loss.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip is not None:
            clip_by_global_norm_(grads, norm, self.clip)
        self.optimizer.step()
        self.iteration += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        return metrics


def make_train_step(model, cfg, device=None, *, steps_per_epoch: int,
                    seed: int = 0, optim_cfg=None) -> TrainStep:
    """Returns the `TrainStep` of `model` on `device` (CUDA by default;
    raises when there is no card unless the caller asks for the CPU):
    `step(batch, noise=None) -> metrics`. The losses read `cfg`, the model
    configuration.

    The optimizer lives in the step. It reads `optimizer`,
    `optimizer_config` and `lr_config` from `optim_cfg`: the run's
    top-level config, where the presets keep them (the JAX package builds
    its optimizer from there too, `tools/train.py`). Without `optim_cfg` it
    reads them from `cfg`, where a flat configuration such as bench.py's
    holds them. The LR milestones are in epochs of `steps_per_epoch`
    iterations, the length of the caller's loader, as the JAX package's
    `build_optimizer` takes it. Dropout and the automask noise are drawn
    from one generator on the device seeded with `seed`; `noise` replaces
    the automask draw.
    K3's gates follow the cfg keys `use_pallas_conv(_deep)` as in the eval
    step.
    """
    return TrainStep(model, cfg, resolve_device(device), steps_per_epoch, seed, optim_cfg)


class Trainer:
    """The epoch loop of `jperceiver_tpu/engine/trainer.py::Trainer`:
    `set_epoch` each epoch, a background prefetch of two batches, a train
    payload every `log_interval` steps, `checkpoint_fn(step, epoch)` and
    `eval_hook(step, epoch)` after each epoch (the step is the `TrainStep`,
    which holds the model, optimizer, iteration and generator), an
    `epoch_time` payload, and a `torch.profiler` trace of steps 10-14 of the
    first epoch in `profile_dir`. Payloads carry the JAX Trainer's keys.

    `cfg` is the run's config as `Config.fromfile` gives it: the losses read
    `cfg.model` (the model configuration the JAX Trainer takes) and the
    optimizer `cfg.optimizer`, `cfg.optimizer_config` and `cfg.lr_config`
    (the JAX package builds it from these in `tools/train.py`, outside its
    Trainer; here the step holds it). A config without `model` raises.

    `data_wait_s` holds, per epoch, the host seconds the loop waited for
    each batch from the prefetch queue (the last entry: the wait for its
    end).
    """

    def __init__(self, model, cfg, train_loader: Iterable, steps_per_epoch: int,
                 device=None, eval_hook: Callable | None = None,
                 checkpoint_fn: Callable | None = None, log_fn: Callable | None = None,
                 log_interval: int = 50, profile_dir: str | None = None):
        if "model" not in cfg:
            raise ValueError("Trainer takes the run's config (with `model`, `optimizer`, "
                             "`optimizer_config`, `lr_config`), not the model's")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.train_loader = train_loader
        self.steps_per_epoch = steps_per_epoch
        self.eval_hook = eval_hook
        self.checkpoint_fn = checkpoint_fn
        self.log_fn = log_fn or (lambda payload: None)
        self.log_interval = log_interval
        self.profile_dir = profile_dir
        self.train_step = make_train_step(model, cfg["model"], self.device,
                                          steps_per_epoch=steps_per_epoch, optim_cfg=cfg)
        self.data_wait_s: list[list[float]] = []

    def _to_device(self, batch: dict, stream):
        """A loader batch on the device. On CUDA the copy runs on the
        prefetch thread's side `stream` from pinned memory; the returned
        event marks its end."""
        if stream is None:
            return batch_to(batch, self.device), None
        with torch.cuda.stream(stream):
            pinned = {k: torch.as_tensor(v).pin_memory() for k, v in batch.items()}
            out = batch_to(pinned, self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _prefetch(self, it: Iterator, n_steps: int) -> Iterator[dict]:
        """Overlap host decode and the host-to-device copy with the steps:
        one background thread keeps up to 2 batches on the device ahead of
        the loop. A loader error is raised here, in the caller."""
        out: queue.Queue = queue.Queue(maxsize=2)
        error: list[BaseException] = []
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def producer():
            try:
                for _ in range(n_steps):
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    out.put(self._to_device(batch, stream))
            except BaseException as e:  # surface loader errors, don't hang
                error.append(e)
            finally:
                out.put(None)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = out.get()
            if item is None:
                if error:
                    raise error[0]
                return
            batch, done = item
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in batch.values():
                    t.record_stream(cur)
            yield batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, total_epochs: int, start_epoch: int = 0) -> TrainStep:
        prof = None
        for epoch in range(start_epoch, total_epochs):
            t_epoch = time.time()
            # Epoch-seeded reshuffle, explicit so that a resumed run sees the
            # same per-epoch order as an uninterrupted one.
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            batches = self._prefetch(iter(self.train_loader), self.steps_per_epoch)
            waits, i = [], 0
            self.data_wait_s.append(waits)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                waits.append(time.perf_counter() - t0)
                if batch is None:
                    break
                if self.profile_dir and epoch == start_epoch and i == _PROFILE_STEPS[0]:
                    prof = self._start_profile()
                metrics = self.train_step(batch)
                i += 1
                if prof is not None and i == _PROFILE_STEPS[1]:
                    prof = self._stop_profile(prof)
                if i % self.log_interval == 0:
                    self.log_fn({"mode": "train", "epoch": epoch + 1, "iter": i,
                                 **{str(k): float(v) for k, v in metrics.items()}})
            if prof is not None:
                prof = self._stop_profile(prof)
            self._sync()
            if self.checkpoint_fn is not None:
                self.checkpoint_fn(self.train_step, epoch + 1)
            if self.eval_hook is not None:
                eval_metrics = self.eval_hook(self.train_step, epoch + 1)
                if eval_metrics:
                    self.log_fn({"mode": "val", "epoch": epoch + 1, **eval_metrics})
            self.log_fn({"mode": "epoch_time", "epoch": epoch + 1,
                         "seconds": time.time() - t_epoch})
        return self.train_step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, "steps_%d_%d.trace.json" % (_PROFILE_STEPS[0],
                                                          _PROFILE_STEPS[1] - 1)))
        return None
