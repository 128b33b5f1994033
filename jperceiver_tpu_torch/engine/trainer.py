"""The training step and the epoch loop (counterpart of
`jperceiver_tpu/engine/trainer.py`): `make_train_step` runs one step --
forward in training mode, CGT label, losses, backward, global-norm clip and
the optimizer update, with the BatchNorm running statistics updated by the
forward -- and `Trainer.fit` runs epochs of it over a loader, with a
background prefetch, log payloads, per-epoch callbacks and a profiler
trace.

There is no autocast: the model casts to its compute dtype where the JAX
modules do, and the outputs, geometry and losses are fp32.

Under a process group (`parallel.init_distributed`) the step is data
parallel, as the JAX step is over its mesh: the model runs inside
`DistributedDataParallel`, each rank on its shard of the global batch, and
BatchNorm, the two batch-wide loss ratios and the random draws are those of
the global batch (`parallel/dist.py`), so a W-rank step at B a rank is the
one-process step at W * B.

On CUDA the step is captured as a CUDA graph (`graph`,
`engine/graphs.py`), as the JAX package jits its step: forward, CGT
label, losses, backward, clip and the optimizer update are one graph,
replayed once a call, the parameters, Adam's moments and the BatchNorm
statistics updated in place (JAX's `donate_argnums`). Under an NCCL
process group the graph can hold the step's collectives too, as the JAX
step over its mesh holds its `psum`s: DDP's gradient all-reduce, the
global BatchNorm's, the loss denominators' and ZeRO-1's broadcasts. That
is the default at one rank; at more ranks it is `graph=True`'s opt-in
(`engine/graphs.py::use_graphs`). Under gloo the data-parallel step runs
eagerly.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import torch

from .. import parallel as dist
from .._device import resolve_device
from ..losses.multitask import compute_losses, total_loss
from ..models.common import kernel_gates, set_bn_groups, set_kernels
from ..tracing import mark, span, timed
from .graphs import GraphCache, tensor_key, use_graphs
from .infer import conv_gates_from_cfg
from .optim import build_optimizer, clip_by_global_norm_, global_norm, param_labels, set_lr

_LABELS = ("bev_static", "bev_dynamic")
# Steps [start, stop) of the first epoch that `Trainer.fit` traces, as the
# JAX Trainer does.
_PROFILE_STEPS = (10, 15)


@contextlib.contextmanager
def deterministic_cudnn():
    """The step's cuDNN convolutions on deterministic algorithms (cuDNN's
    other flags as they are), restored after: the algorithm cuDNN picks for
    a backward may otherwise add atomically, and the step would not repeat
    bit for bit on the card."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = before


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
    `generator` (dropout and the automask noise). The step repeats bit for
    bit on the card: from the same state and batch it gives the same
    gradients and weights (cuDNN on its deterministic algorithms,
    `deterministic_cudnn`; the step's functions whose CUDA backward adds
    atomically have backwards that add in a fixed order).

    Under a process group `model` stays the module itself and `ddp` is its
    `DistributedDataParallel` wrapper, which runs the forward: the clip
    reads the gradients DDP has averaged (the global norm), and the losses
    returned are this rank's shares (`reduce_metrics` gives their mean,
    the global batch's values). DDP is built with `static_graph=True`, on
    a side stream on the card, as PyTorch's recipe for capturing it asks:
    the same buckets and the same unused parameters every iteration.

    With `graphed` the step is a CUDA graph a batch shape (`GraphCache`):
    the metrics it returns are the graph's static outputs, which the next
    step at that shape writes over (read or clone them before), and the
    parameters' `.grad` are the graph's gradients. The first step at a
    shape runs eagerly, the second captures; under DDP the step captures
    once DDP has run `graphs.DDP_WARMUP` eager iterations (its first key's
    12th step). Every rank captures at the same step. The generator is
    registered with each graph, so that every replay draws what the eager
    step would. A restore drops the graphs (`graphs.clear()`): it replaces
    the optimizer's state tensors that they read (`engine/checkpoint.py`);
    the next step at a shape runs eagerly and the one after captures
    again.
    """

    def __init__(self, model, cfg, device, steps_per_epoch: int, seed: int, optim_cfg=None,
                 zero1: bool = False, graph: bool | None = None):
        self.device = device
        self.model = model.to(device).train()
        self.cfg = cfg
        set_kernels(model, *conv_gates_from_cfg(cfg))
        set_bn_groups(model, cfg.get("bn_groups", 1))
        self.ddp = model
        if dist.is_distributed():
            from torch.nn.parallel import DistributedDataParallel

            from ..models.jperceiver import JPerceiver

            # A branch built without a loss (skip_inactive_branch=False on a
            # one-branch type) gives its parameters no gradient.
            scored = JPerceiver.branches_from_cfg({"type": cfg.get("type", "static")})
            unused = getattr(model, "branches", scored) != scored
            # Running statistics stay each rank's own (BatchNorm2d keeps
            # them equal), not rank 0's broadcast.
            ids, side = None, contextlib.nullcontext()
            if device.type == "cuda":
                ids = [torch.cuda.current_device() if device.index is None else device.index]
                side = torch.cuda.stream(torch.cuda.Stream(device))
                side.stream.wait_stream(torch.cuda.current_stream(device))
            # The gradients stay autograd's own tensors, which DDP fills from
            # its buckets (no `gradient_as_bucket_view`): in a graph they are
            # the graph's outputs.
            with side:
                self.ddp = DistributedDataParallel(
                    model, device_ids=ids, broadcast_buffers=False,
                    find_unused_parameters=unused, static_graph=True)
            if device.type == "cuda":
                torch.cuda.current_stream(device).wait_stream(side.stream)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        labels = param_labels(model)
        self.params = [p for _, p in named]
        self.optimizer, self.schedule, self.clip = build_optimizer(
            cfg if optim_cfg is None else optim_cfg, self.params, steps_per_epoch,
            labels=[labels[n] for n, _ in named], zero1=zero1)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.iteration = 0
        self.graphed = use_graphs(graph, device, "make_train_step", collectives=True)
        self.graphs = GraphCache(self._run, "the training step", (self.generator,),
                                 collectives=True)
        self._gates = kernel_gates(model)

    def __call__(self, batch: dict, noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        with span("train_step"):
            with span("train_step.inputs"):
                batch = batch_to(batch, self.device)
                # The learning rate on the device, filled before the step (or
                # its replay) reads it.
                set_lr(self.optimizer, self.schedule, self.iteration)
                if self.graphed:
                    self.model.train()  # the mode the eager forward leaves
                    inputs = dict(batch, noise=noise)
                    key = (tensor_key(inputs), self._gates())
            if self.graphed:
                metrics, grads = self.graphs.run(key, inputs)
                with span("train_step.grads"):
                    for p, g in zip(self.params, grads):
                        p.grad = g
            else:
                metrics, _ = self._run(noise, **batch)
            self.iteration += 1
        return metrics

    def _run(self, noise=None, **batch):
        """The step's device work, what a graph holds: the forward, the
        losses, the backward, the clip and the update. Returns the metrics
        and each parameter's gradient.

        Device phase marks (`tracing.mark`) bound its phases: `forward`,
        `losses` (with `cgt`, the CGT label, inside, `losses/multitask.py`),
        `backward` (under remat with the recomputed forward), `update` (the
        global norm, the clip and the optimizer), `end`."""
        self.optimizer.zero_grad(set_to_none=True)
        with deterministic_cudnn():
            mark("forward", self.device)
            outputs = self.ddp(batch, train=True, generator=self.generator)
            mark("losses", self.device)
            losses = compute_losses(outputs, batch, self.cfg, noise=noise,
                                    generator=self.generator)
            loss = total_loss(losses)
            mark("backward", self.device)
            loss.backward()
        mark("update", self.device)
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip is not None:
            clip_by_global_norm_(grads, norm, self.clip)
        self.optimizer.step()
        mark("end", self.device)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        return metrics, [p.grad for p in self.params]

    @staticmethod
    def reduce_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The mean of each metric over the ranks (one all-reduce; every
        rank calls it): the global batch's losses. One process: `metrics`.
        It reads a captured step's static outputs outside the graph, on the
        communicator whose collectives the graph replays: NCCL allows that
        with `NCCL_GRAPH_MIXING_SUPPORT` on, its default, which
        `parallel.can_capture` checks."""
        if not dist.is_distributed():
            return metrics
        mean = dist.all_reduce_mean(torch.stack([v.double() for v in metrics.values()]))
        return dict(zip(metrics, mean))


def make_train_step(model, cfg, device=None, *, steps_per_epoch: int,
                    seed: int = 0, optim_cfg=None, zero1: bool = False,
                    graph: bool | None = None) -> TrainStep:
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
    step, BatchNorm's groups `bn_groups` (default 1, the global batch).
    Under a process group the step is data parallel (DDP, every rank
    seeded alike); `zero1` shards Adam's moments over the ranks
    (`build_optimizer`).

    `graph` (the counterpart of JAX's `jit`, `engine/graphs.py`): None
    captures the step as a CUDA graph on CUDA, under a one-rank NCCL
    process group too (collectives and all, after `graphs.DDP_WARMUP`
    eager steps), and runs it eagerly under gloo and under NCCL at more
    ranks; False runs it eagerly; True captures (under NCCL at any number
    of ranks) or raises. A captured step returns its graph's static
    metrics, which the next step writes over.
    """
    return TrainStep(model, cfg, resolve_device(device), steps_per_epoch, seed, optim_cfg,
                     zero1, graph)


class Trainer:
    """The epoch loop of `jperceiver_tpu/engine/trainer.py::Trainer`:
    `set_epoch` each epoch, a background prefetch of two batches, a train
    payload every `log_interval` steps, `checkpoint_fn(step, epoch)` and
    `eval_hook(step, epoch)` after each epoch (the step is the `TrainStep`,
    which holds the model, optimizer, iteration and generator), an
    `epoch_time` payload, and a `torch.profiler` trace of five steps of the
    first epoch in `profile_dir`: steps 10-14, or under DDP with a captured
    step the five after its capture, so that it traces replays only.
    Payloads carry the JAX Trainer's keys.
    `fit_resilient` is `fit` that restores the newest checkpoint and goes on
    after a runtime or I/O failure.

    `cfg` is the run's config as `Config.fromfile` gives it: the losses read
    `cfg.model` (the model configuration the JAX Trainer takes) and the
    optimizer `cfg.optimizer`, `cfg.optimizer_config` and `cfg.lr_config`
    (the JAX package builds it from these in `tools/train.py`, outside its
    Trainer; here the step holds it). A config without `model` raises.

    `seed` seeds the step's generator (dropout, the automask noise).
    Under a process group every rank runs the loop on its shard of each
    epoch; the train payloads carry the ranks' mean of each metric,
    all-reduced at log steps only.

    `data_wait_s` holds, per epoch, the host seconds the loop waited for
    each batch from the prefetch queue (the last entry: the wait for its
    end), each timed as `fit.data_wait` (`tracing.py`). The loop's log
    payloads, checkpoints and eval hook are spans (`fit.log`,
    `fit.checkpoint`, `fit.eval`), and so are the prefetch thread's load
    and upload of each batch (`prefetch.load`, `prefetch.upload`): a
    profiler trace (`profile_dir`) shows them beside the steps' own.

    `graph` is `make_train_step`'s: on CUDA the step is a CUDA graph by
    default, under a one-rank NCCL process group too. The prefetch thread copies
    each batch on its side stream; the step waits for that copy's event,
    then copies the batch into the graph's static inputs on its own
    stream. The loop reads a step's metrics before the next step writes
    over them.
    """

    def __init__(self, model, cfg, train_loader: Iterable, steps_per_epoch: int,
                 device=None, eval_hook: Callable | None = None,
                 checkpoint_fn: Callable | None = None, log_fn: Callable | None = None,
                 log_interval: int = 50, profile_dir: str | None = None, seed: int = 0,
                 graph: bool | None = None):
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
                                          steps_per_epoch=steps_per_epoch, seed=seed,
                                          optim_cfg=cfg, graph=graph)
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
        the loop. A loader error is raised here, in the caller. When the
        loop stops early (a failed step), the thread stops too and the
        batches it holds are dropped."""
        out: queue.Queue = queue.Queue(maxsize=2)
        error: list[BaseException] = []
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def producer():
            try:
                for _ in range(n_steps):
                    try:
                        with span("prefetch.load"):
                            batch = next(it)
                    except StopIteration:
                        break
                    with span("prefetch.upload"):
                        item = self._to_device(batch, stream)
                    while not stop.is_set():
                        try:
                            out.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            pass
                    if stop.is_set():
                        return
            except BaseException as e:  # surface loader errors, don't hang
                error.append(e)
            finally:
                if not stop.is_set():
                    out.put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
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
        finally:
            stop.set()
            while not out.empty():
                out.get_nowait()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit_resilient(self, total_epochs: int, work_dir: str, start_epoch: int = 0,
                      max_restarts: int = 3) -> TrainStep:
        """`fit` that recovers from a failure: on a `RuntimeError` or an
        `OSError` it logs a `{"mode": "restart", "error", "attempt"}`
        payload, restores the newest checkpoint under `work_dir` into the
        live `TrainStep` in place (model, optimizer, iteration, generator)
        and goes on from that checkpoint's epoch, up to `max_restarts`
        times. When `work_dir` holds no checkpoint yet, it first saves one
        of the state it starts from, as epoch `start_epoch`, so that every
        restart restores a checkpoint. Programming errors (`TypeError`,
        `ValueError`, `KeyError`, ...) are raised at once: a restart would
        only repeat them.

        On the card a restart mends what leaves the CUDA context usable: a
        loader or file-system failure, an out-of-memory error. An error that
        breaks the context (an illegal address, a device-side assert) fails
        every later CUDA call in the process, and the restored step with
        it; only a new process recovers from that (`tools/train.py
        --resume_from`). Under a process group every rank restores; a
        failure on one rank alone leaves the others in their next
        collective until its timeout fails them too.
        """
        from .checkpoint import latest_epoch, restore_checkpoint, save_checkpoint

        # Rank 0 decides: every rank takes part in a save.
        if dist.rank0_value(latest_epoch(work_dir) is None):
            save_checkpoint(work_dir, self.train_step, start_epoch)
        restarts = 0
        while True:
            try:
                return self.fit(total_epochs, start_epoch=start_epoch)
            except (RuntimeError, OSError) as e:
                restarts += 1
                if restarts > max_restarts:
                    raise
                self.log_fn({"mode": "restart", "error": str(e)[:200], "attempt": restarts})
                start_epoch = restore_checkpoint(work_dir, self.train_step)

    def fit(self, total_epochs: int, start_epoch: int = 0) -> TrainStep:
        prof, profiled = None, self._profiled_steps()
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
                with timed("fit.data_wait") as wait:
                    batch = next(batches, None)
                waits.append(wait.seconds)
                if batch is None:
                    break
                if self.profile_dir and epoch == start_epoch and i == profiled[0]:
                    prof = self._start_profile()
                metrics = self.train_step(batch)
                i += 1
                if prof is not None and i == profiled[1]:
                    prof = self._stop_profile(prof)
                if i % self.log_interval == 0:
                    with span("fit.log"):
                        metrics = self.train_step.reduce_metrics(metrics)
                        self.log_fn({"mode": "train", "epoch": epoch + 1, "iter": i,
                                     **{str(k): float(v) for k, v in metrics.items()}})
            if prof is not None:
                prof = self._stop_profile(prof)
            self._sync()
            if self.checkpoint_fn is not None:
                with span("fit.checkpoint"):
                    self.checkpoint_fn(self.train_step, epoch + 1)
            if self.eval_hook is not None:
                with span("fit.eval"):
                    eval_metrics = self.eval_hook(self.train_step, epoch + 1)
                if eval_metrics:
                    self.log_fn({"mode": "val", "epoch": epoch + 1, **eval_metrics})
            self.log_fn({"mode": "epoch_time", "epoch": epoch + 1,
                         "seconds": time.time() - t_epoch})
        return self.train_step

    def _profiled_steps(self) -> tuple[int, int]:
        """The first step the profiler traces and the step after its last:
        10-14, or under DDP the five after the capture (`graphs.DDP_WARMUP`
        warm-ups, then the capture), replays only."""
        first, end = _PROFILE_STEPS
        if getattr(self.train_step, "graphed", False):  # a TrainStep, not a stand-in
            first = max(first, self.train_step.graphs.warmup + 1)
        return first, first + end - _PROFILE_STEPS[0]

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # Every thread: the prefetch thread's spans too.
        prof = profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        rank = f"_rank{dist.rank()}" if dist.world_size() > 1 else ""
        first, last = self._profiled_steps()
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, "steps_%d_%d%s.trace.json" % (first, last - 1, rank)))
        return None
