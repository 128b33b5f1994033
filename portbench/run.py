"""The benchmark of `jperceiver_tpu_torch` on NVIDIA H100 cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. A run loads the cell of `BENCHMARK.json`,
its configuration (`configs/`) and traffic mix (`traffic/`), whose driver
(`drivers/`) builds the program on the card with weights and inputs made
from the seed and warms up every shape the traffic uses: that is
`setup_s`, from the process's start to the first timed unit. It then
measures for `--seconds`, the window ended by a synchronize. With
`--trace 1` the profiler traces a fixed slice of the window (`Slice`)
and the per-layer metrics are read from it (`metrics/`, each handed
`reader_context`); with `--trace 0` the end-to-end metrics are
reported, and nothing is traced or counted in or around the window.
Once the window has closed, the peak memory is read, the program is
freed and the plain reference
(`reference/`, fp32, TF32 off) checks what the timed path produced
(`compare.py`, `limits/`).

The last line of standard output is the result, one JSON object; the
numbers compared, beside their limits, are the last lines of standard
error. Without a card, or with fewer cards than the cell asks for, a run
fails and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jperceiver_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver is handed (`cell`, `cfg`, `traffic`, `seed`, `device`),
    and a metric's reader (`reader_context`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _launch_shapes() -> dict:
    """The program's K3 and K4 launches so far by shape
    (`ops.cuda.launch_shapes()`), once the program is loaded; else empty."""
    kernels = sys.modules.get("jperceiver_tpu_torch.ops.cuda")
    return getattr(kernels, "launch_shapes", dict)()


class Slice:
    """The traced slice of a run. Opening it synchronizes, takes a snapshot
    of `_launch_shapes()`, starts the profiler and opens the span
    `portbench.slice`; `close()` synchronizes, closes the span, stops the
    profiler and takes the second snapshot. It then holds `events` (the
    trace's, with thread ids), `window` (the slice span's (t0, t1),
    microseconds) and `launch_shapes` (the launches made in between)."""

    NAME = "portbench.slice"

    def __init__(self, sync, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync, self._record = sync, record_function
        sync()
        self._before = _launch_shapes()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        self._span = record_function(self.NAME)
        self._span.__enter__()

    def span(self, name: str):
        """A host span `name` in the slice, around one unit."""
        return self._record(name)

    def close(self) -> "Slice":
        from portbench.trace import profile_events

        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        after = _launch_shapes()
        self.launch_shapes = {k: n - self._before.get(k, 0) for k, n in after.items()
                              if n != self._before.get(k, 0)}
        self.events = profile_events(self._prof)
        self._prof = None
        span = max((e for e in self.events if e["name"] == self.NAME
                    and e["cat"] == "user_annotation"), key=lambda e: e["dur"])
        self.window = (span["ts"], span["ts"] + span["dur"])
        return self


def reader_context(sl: Slice, cfg: dict, flops_pass: dict, units: int, unit: str) -> Context:
    """What a per-layer metric's reader (`metrics/<base>.py`) is handed for
    the closed slice `sl` of `units` units spanned `unit`: `reduced` (the
    slice reduced, `trace.Reduced`, its idle gaps named on the units'
    thread), `events` (the slice's, with thread ids), `window` ((t0, t1),
    microseconds), `phases` (`phases.Phases` of the slice, with the kernel
    classes), `launch_shapes` (K3's and K4's launches in the slice by
    shape; empty where the program counts none), `work` (`flops.count` of
    a unit), `cfg`, and the peaks of the compute dtype: `flops_per_s`,
    `hbm_bytes_per_s`, `bytes_per_element`."""
    from portbench import flops, spec
    from portbench.phases import Phases
    from portbench.trace import Reduced, unit_thread

    classes = spec.kernel_classes()
    bf16 = cfg["model"].get("compute_dtype", "float32") == "bfloat16"
    peaks = spec.peaks()
    return Context(
        reduced=Reduced(sl.events, sl.window, classes, units, unit_thread(sl.events, unit)),
        work=flops.count(cfg["model"], flops_pass), cfg=cfg,
        hbm_bytes_per_s=peaks["hbm_bytes_per_s"],
        flops_per_s=peaks["bf16_flops_per_s" if bf16 else "tf32_flops_per_s"],
        bytes_per_element=2 if bf16 else 4, events=sl.events, window=sl.window,
        # The trace holds the slice's device work alone (a synchronize before
        # the profiler starts and before it stops), so the phases take it
        # whole: the device's stamps of the last unit can pass the span's end.
        phases=Phases(sl.events, None, classes), launch_shapes=sl.launch_shapes)


def per_layer(bench: dict, cell_name: str, rctx: Context, root=None) -> dict:
    """{name: {value, unit}} of the cell's per-layer metrics, each read by
    its reader under `root` (`portbench/` by default); a reader that finds
    nothing leaves its metric out."""
    from portbench import spec

    out = {}
    for m in spec.metrics_of(bench, cell_name, "per_layer"):
        value = spec.metric_reader(m["name"], root or spec.HERE)(rctx, m)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(cell_name: str, seed: int, seconds: float, trace: bool, device=None, *,
        t0: float | None = None, controls: bool = False, log=print) -> dict:
    """One run of a cell; returns the result (the keys of the last line,
    `checks` last; with `controls` also `numbers`, every reading of the
    program, and `controls`, the control's). `device` None is the first
    card."""
    import torch

    from portbench import compare, spec
    from portbench.reference.train import exact

    t0 = _T0 if t0 is None else t0
    bench = spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    limits = spec.load_limits(cell_name)
    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed), device=dev)
    driver = spec.load_driver(traffic["driver"]).Driver(ctx)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    log(f"portbench: set-up {setup_s:.3f} s")

    trace_after, trace_steps = int(traffic["trace_after"]), int(traffic["trace_steps"])
    unit = f"portbench.{traffic['driver']}"
    sl = traced = None
    frames = units = failed = 0
    start = time.perf_counter()
    deadline = start + seconds
    # A traced run goes on past the deadline until its slice is traced.
    while time.perf_counter() < deadline or (trace and traced is None):
        if trace and units == trace_after and traced is None:
            sl = Slice(sync, cuda)  # the slice holds its own units' device work, no backlog
        span = sl.span(unit) if sl is not None else contextlib.nullcontext()
        try:
            with span:
                frames += driver.step()["frames"]
        except Exception as exc:  # a failed unit counts, and the window goes on
            failed += 1
            log(f"portbench: unit {units} failed: {exc!r}"[:400])
        units += 1
        if sl is not None and units == trace_after + trace_steps:
            traced, sl = sl.close(), None
    sync()
    window_s = time.perf_counter() - start
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {', '.join(found)}")

    window = {"frames": frames, "seconds": window_s, "units": units - failed}
    metrics = {}
    if not trace:
        values = driver.end_to_end(window)
        for m in spec.metrics_of(bench, cell_name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        rctx = reader_context(traced, cfg, driver.flops_pass(), trace_steps, unit)
        for name, sec in rctx.reduced.unclassed.most_common():
            log(f"portbench: unclassed device op {sec:.6f} s: {name}")
        metrics.update(per_layer(bench, cell_name, rctx))
        device_info.update(busy_s=rctx.reduced.busy_s, window_s=rctx.reduced.window_s)
        breakdown = rctx.reduced.breakdown()
        del rctx, traced  # the slice's events, before the reference runs

    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    with exact():
        numbers = driver.numbers()
        control = driver.numbers(control="bf16") if controls else None
    log(f"portbench: readings {json.dumps(numbers)}")
    correct, table = compare.judge(numbers, limits)
    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if controls:  # every reading, for the calibration of the limits
        result.update(numbers=numbers, controls=control)
    result["checks"] = table
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import spec

    chips = int(spec.cell(spec.load_benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), power limit: {power_limit()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 log=lambda s: print(s, flush=True))
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
