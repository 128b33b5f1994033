"""`BENCHMARK.json` as data, and the discovery of each kind of file by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in BENCH[kind]:
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_of(BENCH, w["name"], "per_layer")
        assert layer
        for m in layer:  # each per-layer metric's cell reports what it moves
            assert m["moves"] in e2e


def test_workloads_key_parsing():
    bench = {"workloads": [{"name": "a"}, {"name": "b"}],
             "end_to_end": [{"name": "x", "workloads": ["a"]}, {"name": "setup_s"}],
             "per_layer": []}
    assert spec.metric_workloads({"name": "m", "moves": "x"}, bench) == ["a"]
    assert spec.metric_workloads({"name": "m", "moves": "setup_s"}, bench) == ["a", "b"]
    assert spec.metric_workloads({"name": "m", "moves": "x", "workloads": ["b"]}, bench) == ["b"]
    with pytest.raises(ValueError):
        spec.metric_workloads({"name": "m", "workloads": ["c"]}, bench)
    with pytest.raises(ValueError):
        spec.metric_workloads({"name": "m", "workloads": ["a,b"]}, bench)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_by_name(w):
    cfg = spec.load_config(w["config"])
    assert cfg["name"] == w["config"]
    traffic = spec.load_traffic(w["traffic"])
    assert hasattr(spec.load_driver(traffic["driver"]), "Driver")
    assert spec.load_limits(w["name"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert spec.ROOT.joinpath(entry["file"]).is_file()


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    assert callable(spec.metric_reader(m["name"]))


def test_kernel_classes_are_found_and_ordered():
    classes = spec.kernel_classes()
    names = [c["name"] for c in classes]
    assert {"conv", "elementwise", "reduction", "copy", "normalization", "nccl",
            "hand_kernels", "memcpy"} <= set(names)
    assert spec.classify("conv3x3_bf16_wgmma", "kernel", classes) == "conv"
    assert spec.classify("reproj_fwd", "kernel", classes) == "hand_kernels"
    assert spec.classify("ncclDevKernel_AllReduce", "kernel", classes) == "nccl"
    assert spec.classify("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", classes) == "memcpy"
    assert spec.classify("a_kernel_no_class_names", "kernel", classes) == "other"


@pytest.fixture
def copy_of_portbench(tmp_path):
    dst = tmp_path / "portbench"
    shutil.copytree(spec.HERE, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "drivers", "metrics",
                                  "kernel_classes"])
def test_a_file_dropped_in_is_picked_up(copy_of_portbench, kind):
    root = copy_of_portbench
    if kind == "configs":
        (root / "configs" / "new_cfg.json").write_text('{"name": "new_cfg", "model": {}}')
        assert spec.load_config("new_cfg", root)["name"] == "new_cfg"
    elif kind == "traffic":
        (root / "traffic" / "new_mix.json").write_text('{"driver": "train", "batch": 5}')
        assert spec.load_traffic("new_mix", root)["batch"] == 5
    elif kind == "limits":
        (root / "limits" / "train.new_cfg.json").write_text('{"loss": 0.5}')
        assert spec.load_limits("train.new_cfg", root) == {"loss": 0.5}
    elif kind == "drivers":
        (root / "drivers" / "new_driver.py").write_text("class Driver:\n    pass\n")
        assert hasattr(spec.load_driver("new_driver", root), "Driver")
    elif kind == "metrics":
        (root / "metrics" / "new_metric.py").write_text("def read(ctx, metric):\n    return 7.0\n")
        assert spec.metric_reader("new_metric.train", root)(None, None) == 7.0
    else:
        (root / "kernel_classes" / "fused.json").write_text(
            '{"name": "fused", "order": 0, "patterns": ["^my_fused_kernel$"]}')
        classes = spec.kernel_classes(root)
        assert classes[0]["name"] == "fused"
        assert spec.classify("my_fused_kernel", "kernel", classes) == "fused"
    with pytest.raises(FileNotFoundError):
        spec.load_config("absent_cfg", root)
