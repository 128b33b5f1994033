"""The reduction of a `torch.profiler` trace of the window's traced slice
to device busy time, idle gaps and time by kernel class.

The profiler's Chrome trace is exported under `TMPDIR`, read back and
deleted. Device operations are its events of category `kernel`,
`gpu_memcpy` and `gpu_memset`; host spans are the harness's own
`user_annotation` events (`portbench.<unit>`).
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_events(prof) -> list[dict]:
    """The trace's complete events as {name, cat, ts, dur} (microseconds)."""
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
             "dur": float(e.get("dur", 0.0))}
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


class Reduced:
    """A traced slice: `window_s`, `busy_s` (the union of device
    operations), `by_class` {class: seconds}, `by_name` {short name:
    seconds}, `unclassed` {name: seconds}, `gaps` [(host span, seconds)]
    longest first, `units` (the units of work traced)."""

    def __init__(self, events, window: tuple[float, float], classes, units: int):
        from portbench.spec import classify

        t0, t1 = window
        dev = [e for e in events if e["cat"] in DEVICE_CATS
               and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
        spans = [e for e in events if e["cat"] == "user_annotation"
                 and e["name"].startswith("portbench.")]
        self.units = units
        self.window_s = (t1 - t0) / 1e6
        busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.by_class = collections.Counter()
        self.by_name = collections.Counter()
        self.unclassed = collections.Counter()
        for e in dev:
            c = classify(e["name"], e["cat"], classes)
            self.by_class[c] += e["dur"] / 1e6
            self.by_name[short_name(e["name"])] += e["dur"] / 1e6
            if c == "other":
                self.unclassed[short_name(e["name"])] += e["dur"] / 1e6
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps = sorted(((self._host(spans, s, e), (e - s) / 1e6) for s, e in gaps),
                           key=lambda g: -g[1])

    @staticmethod
    def _host(spans, s, e) -> str:
        """What the host was doing in an idle gap: the harness span that
        holds its middle, else "outside a unit"."""
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp["ts"] <= mid <= sp["ts"] + sp["dur"]]
        return min(inside, key=lambda sp: sp["dur"])["name"] if inside else "outside a unit"

    def breakdown(self, top: int = 10) -> dict:
        gaps = collections.Counter()
        for name, sec in self.gaps:
            gaps[name] += sec
        return {"device_ops": [[n, s] for n, s in self.by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
