"""Tracing inside the port: host spans, set-up timers and device phase marks.

A leaf module: the kernels (`ops/cuda/_build.py`), the losses and the
entry points import it.

- `span(name)`: a host span, `torch.profiler.record_function("jp." +
  name)` while a `torch.profiler` records, and nothing else otherwise: one
  read of the flag PyTorch keeps for its own operator records, no record
  and no clock. A span lies in the profiler's trace on the clock that the
  device kernels share, so an idle gap of the device can be put down to the
  innermost span that holds it; spans of one thread nest by time, which
  gives each its parent. The n-th span of a name on its thread belongs to
  the n-th unit traced (a step, a request, a loader batch on the prefetch
  thread): `record_function`'s string argument shows in no trace.
- `timed(name)`: a rare host event whose seconds every process keeps
  (`totals()`): a graph's eager warm-up and its capture, the kernel
  library's build or load, the epoch loop's wait for a batch. It reads the
  host clock whether or not a profiler records, and is a span too. An
  event inside another on the same thread counts once, in the inner one:
  the outer keeps its self time.
- `mark(name, device)`: a device phase mark, an empty kernel
  `jp_mark_<name>` (`ops/cuda/csrc/marks.cu`) on the device's current
  stream; nothing on the CPU. A capture records it as a kernel node, so
  every replay of a graph puts its phase boundaries on the device
  timeline, profiled or not: a phase is the device work from its mark to
  the next. Always on: a mark costs one empty kernel. The marks are a
  library of their own, apart from the kernels; where it cannot be built
  (no `nvcc`), the first mark warns and the process runs unmarked.

The names, each read by a reader of traces (README.md, "Tracing"):

- spans: `train_step` with `train_step.inputs`, `graph.copy_in`,
  `graph.launch`, `train_step.grads`; `eval_step` with `eval_step.upload`,
  `graph.copy_in`, `graph.launch`; `stream`;
  `fit.data_wait`, `fit.log`, `fit.checkpoint`, `fit.eval`; on the
  prefetch thread `prefetch.load` and `prefetch.upload`;
- timed: `graph.eager`, `graph.capture`, `kernels.build`, `fit.data_wait`;
- marks, in device order: the training step `forward`, `losses`, `cgt`,
  `losses`, `backward`, `update`, `end` (under remat `backward` holds the
  recomputed forward); the eval forward `eval`, `end`; a streaming chunk
  `chunk`, `end`.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import torch

_profiler = torch.autograd.profiler
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: dict[str, list] = {}
_open = threading.local()  # the timed events open on this thread, innermost last
_unmarked = False  # the marks' library failed to build in this process


def span(name: str):
    """A context manager: the host span `jp.<name>` while a profiler
    records, nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function("jp." + name)


class _Event:
    """What `timed` yields: `seconds`, the event's wall time with its inner
    events', set as it ends; `inner`, its inner events' seconds."""

    def __init__(self):
        self.seconds = 0.0
        self.inner = 0.0


@contextlib.contextmanager
def timed(name: str):
    """A host event timed into `totals()` and spanned; yields an `_Event`."""
    stack = _open.__dict__.setdefault("stack", [])
    event = _Event()
    stack.append(event)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield event
    finally:
        event.seconds = time.perf_counter() - t0
        stack.pop()
        if stack:
            stack[-1].inner += event.seconds
        with _lock:
            total = _totals.setdefault(name, [0, 0.0])
            total[0] += 1
            total[1] += event.seconds - event.inner


def totals() -> dict[str, list]:
    """{name: [events, seconds]} of every timed event in this process, each
    second counted once (an event's own seconds less its inner events')."""
    with _lock:
        return {k: list(v) for k, v in _totals.items()}


def reset_totals() -> None:
    with _lock:
        _totals.clear()


def mark(name: str, device: torch.device) -> None:
    """Launch the empty kernel `jp_mark_<name>` on `device`'s current
    stream; nothing for a device other than CUDA, or once the marks'
    library has failed to build."""
    global _unmarked
    if device.type != "cuda" or _unmarked:
        return
    from .ops.cuda import _build

    try:
        _build.marks_library()
    except Exception as exc:  # whatever stops the build: no nvcc, no host compiler
        _unmarked = True
        warnings.warn(f"phase marks are off in this process: their library did not build "
                      f"({exc})", RuntimeWarning, stacklevel=2)
        return
    index = torch.cuda.current_device() if device.index is None else device.index
    _build.check(_build.mark_launcher(name)(torch._C._cuda_getCurrentRawStream(index)),
                 f"mark {name}")
