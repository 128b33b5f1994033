"""What the program's own tracing shows in a traced slice: device time by
phase between its phase marks, device idle inside the units' replays,
idle gaps named by the innermost span that holds them, K3's and K4's
share of their roofline from the launches the program counted by shape,
and the set-up seconds the program timed.

    python3 -m portbench.phases --workload <cell> --seed <n> [--units <n>]

builds the cell as a run does (its driver, weights and inputs from the
seed, every shape warmed up), traces `--units` units after a synchronize
(the traffic's `trace_steps` by default) and prints one JSON object. It
runs no reference and no window: the end-to-end metrics are `run.py`'s.

The program (`jperceiver_tpu_torch/tracing.py`) marks each phase on the
device with an empty kernel `jp_mark_<phase>`, also inside a CUDA graph's
replay; its host spans are `user_annotation` events named `jp.<name>`;
`ops/cuda.launch_shapes()` counts K3's and K4's launches by shape; and
`tracing.totals()` holds its timed set-up events. A program without them
(before they were added) gives None for each reading here.

`run.py` and `trace.py` do not read these yet; the functions here are
what their readers would call on the slice's events (with the thread
ids that `trace.profile_events` drops) and on the difference of
`launch_shapes()` across the slice.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import sys
import tempfile

from portbench.trace import DEVICE_CATS, _union

MARK = "jp_mark_"
# The marks that open a unit (a training step, an eval forward, a
# streaming chunk); `end` closes it.
UNIT_START = ("forward", "eval", "chunk")
K3_KERNELS = re.compile(r"conv3x3_f32|conv3x3_bf16_wgmma")
K4_KERNELS = re.compile(r"wgrad_f32|wgrad_bf16_wgmma|sum_splits")
SETUP_EVENTS = ("graph.eager", "graph.capture", "kernels.build")


def profile_events(prof) -> list[dict]:
    """The trace's complete events as {name, cat, ts, dur, tid}
    (microseconds)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_phases_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [{"name": e.get("name", ""), "cat": e.get("cat", ""), "ts": float(e["ts"]),
             "dur": float(e.get("dur", 0.0)), "tid": e.get("tid")}
            for e in events if e.get("ph") == "X" and "ts" in e]


def _device(events, window=None):
    dev = [e for e in events if e["cat"] in DEVICE_CATS]
    if window is not None:
        t0, t1 = window
        dev = [e for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    return sorted(dev, key=lambda e: e["ts"])


def _busy(intervals, a: float, b: float) -> float:
    """Microseconds of [a, b] that the merged `intervals` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in intervals)


class Phases:
    """The marks of a slice (`events`, optionally cut to `window`):
    `marks`, their phase names in device order; `busy_s` {phase: device
    busy seconds from each of its marks to the next mark, summed};
    `class_s` {(phase, class): seconds of the device operations that start
    in the phase, by their class in `classes` (`spec.kernel_classes()`)};
    `units`, the units closed by an `end` mark; `unit_s` and
    `unit_idle_s`, the wall and the idle seconds of those units, from the
    mark that opens each to the end of its `end` mark. None of these where
    the slice has no mark."""

    def __init__(self, events, window=None, classes=()):
        from portbench.spec import classify

        dev = _device(events, window)
        merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
        starts = [e["ts"] for e in dev]
        marks = [e for e in dev if e["name"].startswith(MARK)]
        self.marks = [e["name"][len(MARK):] for e in marks]
        self.busy_s: dict[str, float] = collections.Counter()
        self.class_s: dict[tuple, float] = collections.Counter()
        self.units, self.unit_s, self.unit_idle_s = 0, 0.0, 0.0
        opened = None
        for here, nxt in zip(marks, marks[1:]):
            name = here["name"][len(MARK):]
            if name in UNIT_START:
                opened = here["ts"]
            if opened is not None and name != "end":
                self.busy_s[name] += _busy(merged, here["ts"], nxt["ts"]) / 1e6
                for e in dev[bisect.bisect_left(starts, here["ts"]):
                             bisect.bisect_left(starts, nxt["ts"])] if classes else ():
                    self.class_s[name, classify(e["name"], e["cat"], classes)] += e["dur"] / 1e6
            if nxt["name"] == MARK + "end" and opened is not None:
                end = nxt["ts"] + nxt["dur"]
                self.units += 1
                self.unit_s += (end - opened) / 1e6
                self.unit_idle_s += (end - opened - _busy(merged, opened, end)) / 1e6
                opened = None

    def per_unit_ms(self, phase: str) -> float | None:
        if not self.units or phase not in self.busy_s:
            return None
        return 1e3 * self.busy_s[phase] / self.units

    def class_ms(self) -> dict[str, dict[str, float]]:
        """{phase: {class: device ms a unit}}."""
        out: dict[str, dict[str, float]] = collections.defaultdict(dict)
        for (phase, cls), sec in sorted(self.class_s.items()):
            out[phase][cls] = 1e3 * sec / self.units
        return dict(out)

    def idle_ms(self) -> float | None:
        return 1e3 * self.unit_idle_s / self.units if self.units else None


def unit_thread(events, unit_span: str):
    """The thread that runs the units: the thread of the harness's span
    `unit_span` (`portbench.<driver>`)."""
    tids = collections.Counter(e["tid"] for e in events
                               if e["cat"] == "user_annotation" and e["name"] == unit_span)
    return tids.most_common(1)[0][0] if tids else None


def idle_gaps(events, window, tid) -> collections.Counter:
    """Idle seconds of the device within `window`, each gap put down to the
    innermost span, the harness's (`portbench.*`) or the program's (`jp.*`),
    that holds its middle on thread `tid`, else to "outside a unit"."""
    t0, t1 = window
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in _device(events, window))
    spans = [e for e in events if e["cat"] == "user_annotation" and e["tid"] == tid
             and e["name"].startswith(("portbench.", "jp."))]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    out = collections.Counter()
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp["ts"] <= mid <= sp["ts"] + sp["dur"]]
        name = min(inside, key=lambda sp: sp["dur"])["name"] if inside else "outside a unit"
        out[name] += (e - s) / 1e6
    return out


def launch_work(kernel: str, dtype: str, n: int, h: int, w: int, c: int, o: int,
                pad: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K3 or K4 launch from the shape the program
    counted (`launch_shapes()`): FLOPs 2 N Ho Wo C_in C_out 9 at the
    unpadded channels; each operand read and written once at the dtype's
    size, K3's forward bias and K4's weight gradient in fp32. The count of
    PERF.md's kernel table (`chip_smoke.py`, the K3 and K4 rows)."""
    item = 2 if dtype == "bfloat16" else 4
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    flops = 2.0 * n * ho * wo * c * o * 9
    x, y = n * c * h * w, n * o * ho * wo
    if kernel == "conv3x3_wgrad":
        return flops, (x + y) * item + 4 * o * c * 9
    bias = 4 * o if kernel == "conv3x3" else 0
    return flops, (x + o * c * 9 + y) * item + bias


def roofline_s(shapes: dict, kernels: tuple[str, ...], peaks: dict) -> float:
    """The least time the card could take for the `kernels` launches of
    `shapes` ({(kernel, dtype, N, H, W, C_in, C_out, pad): launches}): each
    at the larger of its FLOPs over its dtype's peak (TF32 for float32, as
    `conv_roofline` takes it) and its bytes over the memory rate."""
    total = 0.0
    for key, launches in shapes.items():
        if key[0] not in kernels:
            continue
        flops, nbytes = launch_work(*key)
        peak = peaks["bf16_flops_per_s" if key[1] == "bfloat16" else "tf32_flops_per_s"]
        total += launches * max(flops / peak, nbytes / peaks["hbm_bytes_per_s"])
    return total


def kernel_seconds(events, window, pattern) -> float:
    return sum(e["dur"] for e in _device(events, window)
               if e["cat"] == "kernel" and pattern.search(e["name"])) / 1e6


def conv_rooflines(events, window, shapes: dict, peaks: dict) -> dict:
    """{"k3": %, "k4": %}: the roofline time of the launches of `shapes`
    over the device time of the kernels that ran them; None where either
    is missing."""
    out = {}
    for key, kernels, pattern in (("k3", ("conv3x3", "conv3x3_dgrad"), K3_KERNELS),
                                  ("k4", ("conv3x3_wgrad",), K4_KERNELS)):
        bound, spent = roofline_s(shapes, kernels, peaks), kernel_seconds(events, window,
                                                                          pattern)
        out[key] = 100.0 * bound / spent if bound > 0 and spent > 0 else None
    return out


def setup_seconds(totals: dict | None) -> float | None:
    """Seconds of the program's timed set-up events (`tracing.totals()`):
    graph warm-ups, captures and the kernel library, each counted once."""
    if not totals:
        return None
    seconds = sum(totals[k][1] for k in SETUP_EVENTS if k in totals)
    return seconds if seconds > 0 else None


def _diff(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import spec
    from portbench.run import Context, power_limit

    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    traffic = spec.load_traffic(cell["traffic"])
    ctx = Context(cell=cell, cfg=spec.load_config(cell["config"]), traffic=traffic,
                  seed=args.seed, device=torch.device("cuda"))
    driver = spec.load_driver(traffic["driver"]).Driver(ctx)
    units = args.units or int(traffic["trace_steps"])
    unit = f"portbench.{traffic['driver']}"
    tracing = sys.modules.get("jperceiver_tpu_torch.tracing")
    kernels = sys.modules.get("jperceiver_tpu_torch.ops.cuda")
    shapes = getattr(kernels, "launch_shapes", dict)
    setup = tracing.totals() if tracing else None
    torch.cuda.synchronize()
    before = shapes()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function("portbench.slice"):
            for _ in range(units):
                with record_function(unit):
                    driver.step()
            torch.cuda.synchronize()
    launched = _diff(shapes(), before)
    events = profile_events(prof)
    sl = max((e for e in events if e["name"] == "portbench.slice"
              and e["cat"] == "user_annotation"), key=lambda e: e["dur"])
    window = (sl["ts"], sl["ts"] + sl["dur"])
    busy = _union((max(e["ts"], window[0]), min(e["ts"] + e["dur"], window[1]))
                  for e in _device(events, window))
    busy_s = sum(e - s for s, e in busy) / 1e6
    phases = Phases(events, window, spec.kernel_classes())
    gaps = idle_gaps(events, window, unit_thread(events, unit))
    result = {
        "workload": args.workload, "seed": args.seed, "units": units,
        "device": torch.cuda.get_device_name(0), "power_limit": power_limit(),
        "window_ms": (window[1] - window[0]) / 1e3, "busy_ms": 1e3 * busy_s,
        "busy_ms_per_unit": 1e3 * busy_s / units,
        "marks_first_unit": phases.marks[:8], "mark_units": phases.units,
        "phase_ms": {k: phases.per_unit_ms(k) for k in phases.busy_s},
        "phase_class_ms": phases.class_ms(),
        "replay_idle_ms": phases.idle_ms(),
        "idle_ms_per_unit": 1e3 * ((window[1] - window[0]) / 1e6 - busy_s) / units,
        "idle_gaps_ms": {k: 1e3 * v for k, v in gaps.most_common()},
        "roofline_pct": conv_rooflines(events, window, launched, spec.peaks()),
        "k3_ms_per_unit": 1e3 * kernel_seconds(events, window, K3_KERNELS) / units,
        "k4_ms_per_unit": 1e3 * kernel_seconds(events, window, K4_KERNELS) / units,
        "launch_shapes": {"|".join(map(str, k)): v for k, v in sorted(launched.items())},
        "graph_setup_s": setup_seconds(setup), "setup_totals": setup,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
