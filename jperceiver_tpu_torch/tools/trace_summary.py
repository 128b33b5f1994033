"""Summarise a `torch.profiler` Chrome trace of the training step
(counterpart of `jperceiver_tpu/tools/trace_summary.py`, which reads the
XLA profiler's): the device kernels by name per step, a histogram of their
durations and the top categories (the kernel name up to its template or
argument list).

A trace of the card has device kernel events (`cat` "kernel"); a CPU
trace has none, and its top-level host operators (`cpu_op` events not
inside another on their thread) stand in for them.

  python -m jperceiver_tpu_torch.tools.profile_step --out /tmp/trace --steps 5
  python -m jperceiver_tpu_torch.tools.trace_summary /tmp/trace --steps 5
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

_BUCKETS = (("<5us", 5), ("5-20us", 20), ("20-100us", 100), ("0.1-1ms", 1000),
            (">1ms", float("inf")))


def load_events(path: str) -> list[dict]:
    """The trace's events; `path` is a trace file (.json or .json.gz) or a
    directory, whose newest trace is read."""
    if os.path.isdir(path):
        hits = sorted(glob.glob(os.path.join(path, "**", "*.json*"), recursive=True),
                      key=os.path.getmtime)
        if not hits:
            raise SystemExit(f"no trace .json under {path}")
        path = hits[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def op_events(events: list[dict]) -> tuple[str, list[dict]]:
    """("kernel", the device kernels) when the trace has any, else
    ("cpu_op", the host operators that no other encloses on their thread)."""
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if kernels:
        return "kernel", kernels
    ops = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e.get("dur", 0)))
    top, end = [], {}
    for e in ops:
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= end.get(key, -1.0):
            top.append(e)
            end[key] = e["ts"] + e.get("dur", 0)
    return "cpu_op", top


def category(name: str) -> str:
    """A kernel's name up to its template or argument list (anonymous
    namespaces dropped)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def summarize(path: str, n_steps: int, top: int = 30) -> dict:
    """Prints the summary; returns {"track", "total_ms_per_step",
    "ops_per_step", "kernels": {name: {"count", "us"}} (over the whole
    trace), "histogram", "categories"}."""
    track, ops = op_events(load_events(path))
    if not ops:
        raise SystemExit("no kernel or operator events in the trace")
    count: collections.Counter = collections.Counter()
    dur: collections.Counter = collections.Counter()
    for e in ops:
        count[e["name"]] += 1
        dur[e["name"]] += e.get("dur", 0)
    total_us = sum(dur.values())
    print(f"{track} time: {total_us / n_steps / 1e3:.3f} ms/step, "
          f"{sum(count.values()) / n_steps:.0f} {track} events/step")

    print(f"\n{'ms/step':>9} {'n/step':>7}  name (top {top})")
    for name, d in dur.most_common(top):
        print(f"{d / n_steps / 1e3:9.3f} {count[name] / n_steps:7.1f}  {name[:120]}")

    hist = {b: [0.0, 0.0] for b, _ in _BUCKETS}
    for name, d in dur.items():
        per = d / count[name]
        b = next(b for b, hi in _BUCKETS if per < hi)
        hist[b][0] += count[name] / n_steps
        hist[b][1] += d / n_steps / 1e3
    print()
    for b, (n, ms) in hist.items():
        print(f"{b:>9}: {n:7.0f} events, {ms:8.3f} ms")

    cat: collections.Counter = collections.Counter()
    catn: collections.Counter = collections.Counter()
    for name, d in dur.items():
        cat[category(name)] += d / n_steps / 1e3
        catn[category(name)] += count[name] / n_steps
    print(f"\ntop {top} categories:")
    for c, ms in cat.most_common(top):
        print(f"{ms:9.3f} ms  {catn[c]:7.1f} events  {c[:100]}")
    return {"track": track, "total_ms_per_step": total_us / n_steps / 1e3,
            "ops_per_step": sum(count.values()) / n_steps,
            "kernels": {n: {"count": count[n], "us": dur[n]} for n in count},
            "histogram": hist, "categories": dict(cat)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Summarise a profile_step trace")
    p.add_argument("trace", help="trace directory (profile_step --out) or trace file")
    p.add_argument("--steps", type=int, default=5, help="steps the trace covers")
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)
    return summarize(args.trace, args.steps, args.top)


if __name__ == "__main__":
    main()
