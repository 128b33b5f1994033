"""CUDA graphs of the port's entry points: the counterpart of the JAX
package's `jax.jit` (`jperceiver_tpu/engine/trainer.py:91-92,133`,
`engine/streaming.py:47-52`).

A jitted JAX step is one compiled program that a call dispatches once. Here
the step's launches are recorded once into a CUDA graph and replayed by one
call: the same kernels on the same buffers, so a replay gives the eager
call's numbers bit for bit.

`GraphCache` keeps one graph a key, the shapes and dtypes of a call's
inputs, as jit keeps one program a signature. The first call at a key runs
eagerly: it builds the kernels, picks cuDNN's algorithms, creates the
optimizer's state and fills the caches that later calls read. The next
captures the body on static copies of its inputs (a capture runs nothing)
and replays it; later calls copy their inputs into the static tensors and
replay. Each call runs the body exactly once on the device. The eager
calls before a capture (the warm-ups) run on a side stream, as the capture
does.

Under a process group the data-parallel training step can be captured
too, collectives and all, where the group's backend is NCCL on a card
(`parallel.can_capture`): DDP's bucketed gradient all-reduce, the global
BatchNorm's and the loss denominators' all-reduces and ZeRO-1's
broadcasts become nodes of the graph. By default (`graph=None`) it is
captured under a one-rank NCCL group and runs eagerly under a larger one,
where the captured step has not yet been shown to match the eager step
on cards: `graph=True` captures it there. PyTorch's recipe for capturing DDP
(`torch.cuda.graphs`, "Usage with DistributedDataParallel") is kept:
DDP built with `static_graph=True` on a side stream, and `DDP_WARMUP`
eager iterations on a side stream before the capture, past DDP's bucket
rebuild and its runtime statistics, which it gathers on the host in its
first ten iterations. Every rank warms up, captures and replays at the
same call, and the ranks check once, at the capture, that they capture
the same key: a key one rank alone captured would hang the collectives.
Gloo's collectives run on the host and cannot be captured: a step with
collectives stays eager under gloo.

What a replay returns are the graph's static outputs: the next replay at
the same key writes over them. Read or clone them before that.

A capture that fails raises: nothing runs the body eagerly instead.

Each warm-up and each capture is timed (`tracing.timed`: `graph.eager`,
`graph.capture`); the copy into the static inputs and the replay's launch
are spans (`graph.copy_in`, `graph.launch`, the latter holding the host
while the card drains the replay before).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import parallel as dist
from ..ops.cuda import GraphLaunches
from ..tracing import span, timed


# PyTorch's recipe for capturing DDP: at least 11 eager iterations first.
DDP_WARMUP = 11


def use_graphs(graph: bool | None, device: torch.device, what: str, *,
               collectives: bool) -> bool:
    """The `graph` argument of an entry point. `collectives` says whether
    its body issues collectives under a process group (the training step:
    DDP, BatchNorm, the loss denominators, ZeRO-1) or not (the eval step,
    streaming).

    None captures on CUDA, except a body with collectives under a process
    group of more than one rank, or under a group whose collectives cannot
    be captured (gloo: `parallel.can_capture`), which runs eagerly, as the
    CPU does. False runs eagerly. True captures, and raises where it
    cannot: on the CPU, or for a body with collectives under gloo, naming
    its backend."""
    group = collectives and dist.is_distributed()
    if graph is None:
        return device.type == "cuda" and (
            not group or (dist.world_size() == 1 and dist.can_capture()))
    if graph:
        if device.type != "cuda":
            raise ValueError(f"{what}: graph=True captures a CUDA graph; the device is "
                             f"{device}")
        if group and not dist.can_capture():
            raise ValueError(f"{what}: graph=True under a process group on {dist.backend()}, "
                             "whose collectives run on the host and cannot be captured in a "
                             "CUDA graph (NCCL's can); pass graph=None or False")
    return bool(graph)


def _register_generators(graph, generators) -> None:
    """Each replay must advance `generators` as the eager call does, or
    every replay repeats the first replay's draws."""
    if not generators:
        return
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a "
                           "CUDA graph (CUDAGraph.register_generator_state): a captured "
                           "step would repeat its random draws; pass graph=False")
    for gen in generators:
        register(gen)


@dataclasses.dataclass
class _Captured:
    graph: Any
    inputs: dict[str, torch.Tensor]
    outputs: Any
    launches: GraphLaunches


class GraphCache:
    """`body(**inputs)` run eagerly, or captured and replayed, by key.

    `run(key, copied, held)`: `copied` are the call's inputs, copied into
    the graph's static tensors before each replay; `held` are tensors that
    the body reads and writes in place and that every call passes as the
    same objects (a carry, state), captured as they are. `generators` are
    registered with each graph. `name` names the entry point in errors.

    `collectives`: the body issues collectives (the training step under
    DDP). Under a process group it then warms up `DDP_WARMUP` times and the
    ranks check at each capture that they capture the same key; else it
    warms up once. A call runs eagerly while its key has had no eager call
    or while the cache has made fewer than `warmup` eager calls in all,
    whatever their keys (under DDP: DDP's own eager iterations); the next
    call at that key captures.

    `eager_calls` and `captures` count the calls of each kind, `capture_s`
    each capture's seconds."""

    def __init__(self, body: Callable, name: str, generators=(), collectives: bool = False):
        self.body = body
        self.name = name
        self.generators = tuple(generators)
        self.collectives = collectives and dist.is_distributed()
        self.warmup = DDP_WARMUP if self.collectives else 1
        self.entries: dict = {}
        self.eager_calls = 0
        self.captures = 0
        self.capture_s: list[float] = []
        self._side = None

    def clear(self) -> None:
        """Drop every graph (after a restore replaced what they read)."""
        self.entries.clear()

    def run(self, key, copied: dict, held: dict | None = None):
        held = held or {}
        entry = self.entries.get(key)
        if key not in self.entries or (entry is None and self.eager_calls < self.warmup):
            self.entries[key] = None
            self.eager_calls += 1
            with timed("graph.eager"):
                return self._eager({**copied, **held})
        if entry is None:
            if self.collectives:
                dist.check_same_on_every_rank(key, f"the capture of {self.name}")
            entry = self.entries[key] = self._capture(copied, held)
        else:
            with span("graph.copy_in"), torch.no_grad():
                for k, t in entry.inputs.items():
                    t.copy_(copied[k])
        with span("graph.launch"):
            entry.graph.replay()
        entry.launches.replayed()
        return entry.outputs

    def _eager(self, inputs: dict):
        """A warm-up call, on a side stream on the card (as a capture runs)."""
        if not torch.cuda.is_available():
            return self.body(**inputs)
        if self._side is None:
            self._side = torch.cuda.Stream()
        current = torch.cuda.current_stream()
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = self.body(**inputs)
        current.wait_stream(self._side)
        return out

    def _capture(self, copied: dict, held: dict) -> _Captured:
        with timed("graph.capture") as event:
            static = {k: None if v is None else v.detach().clone() for k, v in copied.items()}
            graph = torch.cuda.CUDAGraph()
            _register_generators(graph, self.generators)
            launches = GraphLaunches()
            try:
                # thread_local: the prefetch thread may allocate pinned memory
                # and copy on its own stream while this thread captures, and
                # NCCL's watchdog queries its events.
                with launches.capture(), torch.cuda.graph(graph,
                                                          capture_error_mode="thread_local"):
                    outputs = self.body(**static, **held)
            except Exception as exc:
                raise RuntimeError(f"CUDA graph capture of {self.name} failed: {exc} "
                                   "(pass graph=False to run it eagerly)") from exc
        self.captures += 1
        self.capture_s.append(event.seconds)
        return _Captured(graph, {k: v for k, v in static.items() if v is not None},
                         outputs, launches)


def tensor_key(tensors: dict) -> tuple:
    """The cache key of a call's tensors: each name with its shape and
    dtype (None where absent)."""
    return tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                 for k, v in sorted(tensors.items()))
