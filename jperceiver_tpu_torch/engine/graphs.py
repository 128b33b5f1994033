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
optimizer's state and fills the caches that later calls read. The second
captures the body on static copies of its inputs (a capture runs nothing)
and replays it; later calls copy their inputs into the static tensors and
replay. Each call runs the body exactly once on the device.

What a replay returns are the graph's static outputs: the next replay at
the same key writes over them. Read or clone them before that.

A capture that fails raises: nothing runs the body eagerly instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from .. import parallel as dist
from ..ops.cuda import GraphLaunches


def use_graphs(graph: bool | None, device: torch.device, what: str) -> bool:
    """The `graph` argument of an entry point: None captures on CUDA
    outside a process group, False runs eagerly (what the CPU always
    does), True captures and raises where it cannot (on the CPU, or under a
    process group, whose collectives this port does not capture)."""
    if graph is None:
        return device.type == "cuda" and not dist.is_distributed()
    if graph:
        if device.type != "cuda":
            raise ValueError(f"{what}: graph=True captures a CUDA graph; the device is "
                             f"{device}")
        if dist.is_distributed():
            raise ValueError(f"{what}: graph=True under a process group; the data-parallel "
                             "step runs eagerly (graph=None or False)")
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
    registered with each graph. `name` names the entry point in errors."""

    def __init__(self, body: Callable, name: str, generators=()):
        self.body = body
        self.name = name
        self.generators = tuple(generators)
        self.entries: dict = {}
        self.captures = 0
        self.capture_s: list[float] = []

    def clear(self) -> None:
        """Drop every graph (after a restore replaced what they read)."""
        self.entries.clear()

    def run(self, key, copied: dict, held: dict | None = None):
        held = held or {}
        if key not in self.entries:
            self.entries[key] = None
            return self.body(**copied, **held)
        entry = self.entries[key]
        if entry is None:
            entry = self.entries[key] = self._capture(copied, held)
        else:
            with torch.no_grad():
                for k, t in entry.inputs.items():
                    t.copy_(copied[k])
        entry.graph.replay()
        entry.launches.replayed()
        return entry.outputs

    def _capture(self, copied: dict, held: dict) -> _Captured:
        t0 = time.perf_counter()
        static = {k: None if v is None else v.detach().clone() for k, v in copied.items()}
        graph = torch.cuda.CUDAGraph()
        _register_generators(graph, self.generators)
        launches = GraphLaunches()
        try:
            # thread_local: the prefetch thread may allocate pinned memory
            # and copy on its own stream while this thread captures.
            with launches.capture(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.body(**static, **held)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {exc} "
                               "(pass graph=False to run it eagerly)") from exc
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
        return _Captured(graph, {k: v for k, v in static.items() if v is not None},
                         outputs, launches)


def tensor_key(tensors: dict) -> tuple:
    """The cache key of a call's tensors: each name with its shape and
    dtype (None where absent)."""
    return tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                 for k, v in sorted(tensors.items()))
