"""The benchmark's specification and the files it finds by name.

`BENCHMARK.json` at the root of the checkout lists the cells (a
configuration under a traffic mix) and the metrics. Everything that
belongs to one item sits in files of its own under `portbench/`:

- `configs/<config>.json`: one model configuration, as it is run;
- `traffic/<traffic>.json`: one traffic mix, the parameters that its
  driver (`drivers/<driver>.py`, named in the file) reads;
- `metrics/<base>.py`: the reader of every per-layer metric named
  `<base>` or `<base>.<suffix>`;
- `kernel_classes/<class>.json`: the kernel-name patterns of one class of
  device operations;
- `limits/<cell>.json`: the limit of each number that decides `correct`.

A new item is a new file and a new entry in `BENCHMARK.json`; no file
that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def metric_workloads(metric: dict, bench: dict) -> list[str]:
    """The cells a metric is reported in: its `workloads` key, or, without
    one, every cell that reports the end-to-end metric it moves (a
    per-layer metric) or every cell (an end-to-end metric)."""
    if "workloads" in metric:
        names = [check_name(n) for n in metric["workloads"]]
        known = {w["name"] for w in bench["workloads"]}
        unknown = sorted(set(names) - known)
        if unknown:
            raise ValueError(f"metric {metric['name']}: unknown workloads {unknown}")
        return names
    moves = metric.get("moves")
    if moves is None:
        return [w["name"] for w in bench["workloads"]]
    e2e = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return metric_workloads(e2e, bench)


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports."""
    return [m for m in bench[kind] if cell_name in metric_workloads(m, bench)]


def _json(folder: str, name: str, root: Path) -> dict:
    path = root / folder / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}.json: no such file under {root}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, root: Path = HERE) -> dict:
    return _json("configs", name, root)


def load_traffic(name: str, root: Path = HERE) -> dict:
    return _json("traffic", name, root)


def load_limits(cell_name: str, root: Path = HERE) -> dict:
    return _json("limits", cell_name, root)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: Path = HERE):
    path = root / "drivers" / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"drivers/{name}.py: no such driver under {root}")
    return _module(path, f"portbench_driver_{name}")


def metric_reader(metric_name: str, root: Path = HERE):
    """The `read(ctx, metric)` of `metrics/<base>.py` for a metric named
    `<base>` or `<base>.<suffix>`."""
    base = check_name(metric_name).split(".")[0]
    path = root / "metrics" / f"{base}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metrics/{base}.py: no reader for {metric_name}")
    return _module(path, f"portbench_metric_{base}").read


def kernel_classes(root: Path = HERE) -> list[dict]:
    """Every `kernel_classes/*.json`, in the order a kernel is matched:
    by `order`, then by name. Each has `name`, `order`, `patterns`
    (regular expressions searched in the kernel's name) and optionally
    `categories` (trace categories such as `gpu_memcpy` that fall in it
    whatever their name)."""
    classes = []
    for path in sorted((root / "kernel_classes").glob("*.json")):
        with open(path) as f:
            c = json.load(f)
        if c.get("name") != path.stem:
            raise ValueError(f"{path.name}: its name is {c.get('name')!r}")
        c["compiled"] = [re.compile(p) for p in c.get("patterns", [])]
        classes.append(c)
    return sorted(classes, key=lambda c: (c.get("order", 100), c["name"]))


def classify(name: str, cat: str, classes: list[dict]) -> str:
    """The class of one device operation, "other" where none names it."""
    for c in classes:
        if cat in c.get("categories", ()) or any(p.search(name) for p in c["compiled"]):
            return c["name"]
    return "other"


def peaks(root: Path = HERE) -> dict:
    with open(root / "peaks.json") as f:
        return json.load(f)
