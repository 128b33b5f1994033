"""The reduction of a `torch.profiler` trace of the window's traced slice
to device busy time, idle gaps named by the host span that holds them,
and time by kernel class. `run.py` and `phases.py` reduce every slice
through it.

The profiler's Chrome trace is exported under `TMPDIR`, read back and
deleted. Device operations are its events of category `kernel`,
`gpu_memcpy` and `gpu_memset`; host spans are its `user_annotation`
events: the harness's (`portbench.slice`, `portbench.<driver>` around
each unit) and the program's (`jp.<name>`, `jperceiver_tpu_torch/
tracing.py`), each on the thread that opened it.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIXES = ("portbench.", "jp.")


def profile_events(prof) -> list[dict]:
    """The trace's complete events as {name, cat, ts, dur, tid}
    (microseconds)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
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


def short_name(name: str) -> str:
    """A kernel's name up to its template or argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:120] or name[:120]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_events(events, window=None) -> list[dict]:
    """The device operations of `events` that overlap `window`, by start."""
    dev = [e for e in events if e["cat"] in DEVICE_CATS]
    if window is not None:
        t0, t1 = window
        dev = [e for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    return sorted(dev, key=lambda e: e["ts"])


def busy_intervals(events, window) -> list[list[float]]:
    """The union of the device operations' intervals, cut to `window`."""
    t0, t1 = window
    return _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in device_events(events, window))


def unit_thread(events, unit_span: str):
    """The thread that runs the units: the thread of the harness's span
    `unit_span` (`portbench.<driver>`)."""
    tids = collections.Counter(e.get("tid") for e in events
                               if e["cat"] == "user_annotation" and e["name"] == unit_span)
    return tids.most_common(1)[0][0] if tids else None


def idle_gaps(events, window, tid) -> list[tuple[str, float]]:
    """Each idle gap of the device within `window`, longest first, as (the
    innermost span, the harness's or the program's, that holds its middle
    on thread `tid`, else "outside a unit"; its seconds)."""
    t0, t1 = window
    spans = [e for e in events if e["cat"] == "user_annotation" and e.get("tid") == tid
             and e["name"].startswith(SPAN_PREFIXES)]
    edges = [t0] + [x for iv in busy_intervals(events, window) for x in iv] + [t1]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp["ts"] <= mid <= sp["ts"] + sp["dur"]]
        name = min(inside, key=lambda sp: sp["dur"])["name"] if inside else "outside a unit"
        gaps.append((name, (e - s) / 1e6))
    return sorted(gaps, key=lambda g: -g[1])


class Reduced:
    """A traced slice: `window_s`, `busy_s` (the union of device
    operations), `by_class` {class: seconds}, `by_name` {short name:
    seconds}, `unclassed` {name: seconds}, `gaps` [(span, seconds)]
    longest first (`idle_gaps` on thread `tid`, the units' thread),
    `units` (the units of work traced)."""

    def __init__(self, events, window: tuple[float, float], classes, units: int, tid=None):
        from portbench.spec import classify

        t0, t1 = window
        self.units = units
        self.window_s = (t1 - t0) / 1e6
        self.busy_s = sum(e - s for s, e in busy_intervals(events, window)) / 1e6
        self.by_class = collections.Counter()
        self.by_name = collections.Counter()
        self.unclassed = collections.Counter()
        for e in device_events(events, window):
            c = classify(e["name"], e["cat"], classes)
            self.by_class[c] += e["dur"] / 1e6
            self.by_name[short_name(e["name"])] += e["dur"] / 1e6
            if c == "other":
                self.unclassed[short_name(e["name"])] += e["dur"] / 1e6
        self.gaps = idle_gaps(events, window, tid)

    def breakdown(self, top: int = 10) -> dict:
        gaps = collections.Counter()
        for name, sec in self.gaps:
            gaps[name] += sec
        return {"device_ops": [[n, s] for n, s in self.by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
