"""The benchmark of `jperceiver_tpu_torch` on NVIDIA H100 cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. A run loads the cell of `BENCHMARK.json`,
its configuration (`configs/`) and traffic mix (`traffic/`), whose driver
(`drivers/`) builds the program on the card with weights and inputs made
from the seed and warms up every shape the traffic uses: that is
`setup_s`, from the process's start to the first timed unit. It then
measures for `--seconds`, the window ended by a synchronize. With
`--trace 1` the profiler traces a fixed slice of the window and the
per-layer metrics are read from it (`metrics/`); with `--trace 0` the
end-to-end metrics are reported. Once the window has closed, the peak
memory is read, the program is freed and the plain reference
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
    """What a driver is handed: `cell`, `cfg`, `traffic`, `seed`, `device`."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


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

    from portbench import compare, flops, spec
    from portbench.reference.train import exact
    from portbench.trace import Reduced, profile_events

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
    prof = slice_span = traced = None
    frames = units = failed = 0
    start = time.perf_counter()
    deadline = start + seconds
    # A traced run goes on past the deadline until its slice is traced.
    while time.perf_counter() < deadline or (trace and traced is None):
        if trace and units == trace_after and slice_span is None:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            sync()  # the slice holds its own units' device work, no backlog
            prof.start()
            slice_span = record_function("portbench.slice")
            slice_span.__enter__()
        span = (record_function(unit) if prof is not None else contextlib.nullcontext())
        try:
            with span:
                frames += driver.step()["frames"]
        except Exception as exc:  # a failed unit counts, and the window goes on
            failed += 1
            log(f"portbench: unit {units} failed: {exc!r}"[:400])
        units += 1
        if prof is not None and units == trace_after + trace_steps:
            sync()
            slice_span.__exit__(None, None, None)
            prof.stop()
            traced, prof = prof, None
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
        events = profile_events(traced)
        window_span = max((e for e in events if e["name"] == "portbench.slice"
                           and e["cat"] == "user_annotation"), key=lambda e: e["dur"])
        reduced = Reduced(events, (window_span["ts"], window_span["ts"] + window_span["dur"]),
                          spec.kernel_classes(), trace_steps)
        del events, traced
        for name, sec in reduced.unclassed.most_common():
            log(f"portbench: unclassed device op {sec:.6f} s: {name}")
        bf16 = cfg["model"].get("compute_dtype", "float32") == "bfloat16"
        peaks = spec.peaks()
        rctx = Context(reduced=reduced, work=flops.count(cfg["model"], driver.flops_pass()),
                       cfg=cfg, hbm_bytes_per_s=peaks["hbm_bytes_per_s"],
                       flops_per_s=peaks["bf16_flops_per_s" if bf16 else "tf32_flops_per_s"],
                       bytes_per_element=2 if bf16 else 4)
        for m in spec.metrics_of(bench, cell_name, "per_layer"):
            value = spec.metric_reader(m["name"])(rctx, m)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        breakdown = reduced.breakdown()

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
