"""What the program's own tracing shows in a traced slice: device time by
phase between its phase marks, device idle inside the units' replays,
K3's and K4's share of their roofline from the launches the program
counted by shape, and the set-up seconds the program timed.

    python3 -m portbench.phases --workload <cell> --seed <n> [--units <n>]

builds the cell as a run does (its driver, weights and inputs from the
seed, every shape warmed up), traces `--units` units (the traffic's
`trace_steps` by default) in the slice that a `--trace 1` run traces
(`run.Slice`), reduces it through the readers' context (`run.
reader_context`) and prints one JSON object. It runs no reference and
no window: the end-to-end metrics are `run.py`'s.

What the program traces (`jperceiver_tpu_torch/tracing.py`) and what
reads it:

- the device marks `jp_mark_<phase>`, empty kernels, also inside a CUDA
  graph's replay: `Phases` below, read by `train_phase_ms.<phase>`
  (`forward`, `losses`, `cgt`, `backward`, `update`) and
  `replay_idle_ms.*`;
- the host spans `jp.<name>` (`user_annotation` events): `trace.
  idle_gaps`, which names each idle gap of `breakdown.idle_gaps` by the
  innermost span that holds it;
- `ops.cuda.launch_shapes()`, K3's and K4's launches by shape, its
  difference across the slice (`Context.launch_shapes`):
  `conv_rooflines` below, read by `k3_roofline.*` and `k4_roofline.*`;
- `tracing.totals()`, its timed set-up events: `setup_seconds` below,
  read by `graph_setup_s`.

A program without them gives None for each reading, and a run leaves
the metric out of its line.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import sys

from portbench.trace import _union, device_events

MARK = "jp_mark_"
# The marks that open a unit (a training step, an eval forward, a
# streaming chunk) where none is open; `end` closes it.
UNIT_START = ("forward", "eval", "chunk")
K3_KERNELS = re.compile(r"conv3x3_f32|conv3x3_bf16_wgmma")
K4_KERNELS = re.compile(r"wgrad_f32|wgrad_bf16_wgmma|sum_splits")
SETUP_EVENTS = ("graph.eager", "graph.capture", "kernels.build")


def _busy(intervals, a: float, b: float) -> float:
    """Microseconds of [a, b] that the merged `intervals` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in intervals)


class Phases:
    """The marks of a slice (`events`, optionally cut to `window`):
    `marks`, their phase names in device order; `busy_s` {phase: device
    busy seconds from each of its marks to the next mark, summed over the
    closed units};
    `class_s` {(phase, class): seconds of the device operations that start
    in the phase, by their class in `classes` (`spec.kernel_classes()`)};
    `units`, the units closed by an `end` mark; `unit_s` and
    `unit_idle_s`, the wall and the idle seconds of those units, from the
    mark that opens each to the end of its `end` mark. A start mark opens a
    unit only where none is open, so a mark of that name inside a unit
    splits its phase and no more; a unit that no `end` mark closes counts
    nowhere. None of these where the slice has no mark."""

    def __init__(self, events, window=None, classes=()):
        from portbench.spec import classify

        dev = device_events(events, window)
        merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
        starts = [e["ts"] for e in dev]
        marks = [e for e in dev if e["name"].startswith(MARK)]
        self.marks = [e["name"][len(MARK):] for e in marks]
        self.busy_s: dict[str, float] = collections.Counter()
        self.class_s: dict[tuple, float] = collections.Counter()
        self.units, self.unit_s, self.unit_idle_s = 0, 0.0, 0.0
        opened = None
        busy, by_class = collections.Counter(), collections.Counter()  # the open unit's
        for here, nxt in zip(marks, marks[1:]):
            name = here["name"][len(MARK):]
            if name in UNIT_START and opened is None:
                opened = here["ts"]
            if opened is not None and name != "end":
                busy[name] += _busy(merged, here["ts"], nxt["ts"]) / 1e6
                for e in dev[bisect.bisect_left(starts, here["ts"]):
                             bisect.bisect_left(starts, nxt["ts"])] if classes else ():
                    by_class[name, classify(e["name"], e["cat"], classes)] += e["dur"] / 1e6
            if nxt["name"] == MARK + "end" and opened is not None:
                end = nxt["ts"] + nxt["dur"]
                self.units += 1
                self.unit_s += (end - opened) / 1e6
                self.unit_idle_s += (end - opened - _busy(merged, opened, end)) / 1e6
                self.busy_s.update(busy)
                self.class_s.update(by_class)
                busy.clear()
                by_class.clear()
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
    return sum(e["dur"] for e in device_events(events, window)
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


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import spec
    from portbench.run import Context, Slice, power_limit, reader_context

    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    traffic = spec.load_traffic(cell["traffic"])
    cfg = spec.load_config(cell["config"])
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=args.seed,
                  device=torch.device("cuda"))
    driver = spec.load_driver(traffic["driver"]).Driver(ctx)
    units = args.units or int(traffic["trace_steps"])
    unit = f"portbench.{traffic['driver']}"
    tracing = sys.modules.get("jperceiver_tpu_torch.tracing")
    setup = tracing.totals() if tracing else None
    sl = Slice(torch.cuda.synchronize, cuda=True)
    for _ in range(units):
        with sl.span(unit):
            driver.step()
    sl.close()
    rctx = reader_context(sl, cfg, driver.flops_pass(), units, unit)
    r, phases = rctx.reduced, rctx.phases
    result = {
        "workload": args.workload, "seed": args.seed, "units": units,
        "device": torch.cuda.get_device_name(0), "power_limit": power_limit(),
        "window_ms": 1e3 * r.window_s, "busy_ms": 1e3 * r.busy_s,
        "busy_ms_per_unit": 1e3 * r.busy_s / units,
        "marks_first_unit": phases.marks[:8], "mark_units": phases.units,
        "phase_ms": {k: phases.per_unit_ms(k) for k in phases.busy_s},
        "phase_class_ms": phases.class_ms(),
        "replay_idle_ms": phases.idle_ms(),
        "idle_ms_per_unit": 1e3 * (r.window_s - r.busy_s) / units,
        "idle_gaps_ms": {k: 1e3 * v for k, v in r.breakdown(len(r.gaps))["idle_gaps"]},
        "roofline_pct": conv_rooflines(rctx.events, rctx.window, rctx.launch_shapes,
                                       spec.peaks()),
        "k3_ms_per_unit": 1e3 * kernel_seconds(rctx.events, rctx.window, K3_KERNELS) / units,
        "k4_ms_per_unit": 1e3 * kernel_seconds(rctx.events, rctx.window, K4_KERNELS) / units,
        "launch_shapes": {"|".join(map(str, k)): v
                          for k, v in sorted(rctx.launch_shapes.items())},
        "graph_setup_s": setup_seconds(setup), "setup_totals": setup,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
