"""What a per-layer metric's reader is handed (`run.reader_context`) on the
canned slices of `test_portbench_trace.py` and `test_portbench_phases.py`:
the readers that were there read what they read before the context held
the slice's events, marks and launches; the readers of the program's
marks and launch counts read them; a reader file dropped into a copy of
`metrics/` reads a mark that no entry uses, with no other file edited;
and the slice itself, traced on the CPU."""

from __future__ import annotations

import sys
import types

import pytest

from portbench import flops, run, spec
from portbench.tests import test_portbench_phases as canned_phases
from portbench.tests import test_portbench_trace as canned_trace

TRAIN = "train.kitti_odom_1024"
SHAPES = {("conv3x3", "float32", 1, 512, 512, 64, 64, 1): 3,
          ("conv3x3_dgrad", "float32", 1, 512, 512, 64, 64, 1): 1,
          ("conv3x3_wgrad", "float32", 1, 512, 512, 64, 64, 1): 2}
# K3 and K4 kernels between the canned phase slice's two steps, inside no
# unit: [300, 340] K3, [350, 370] K4 with [370, 380] its split sums.
CONV = [{"name": "void tf32k::conv3x3_f32_tf32_wgmma(CUtensorMap)", "cat": "kernel",
         "ts": 300.0, "dur": 40.0, "tid": 7},
        {"name": "void f32k::wgrad_f32(float const*)", "cat": "kernel", "ts": 350.0,
         "dur": 20.0, "tid": 7},
        {"name": "void (anonymous namespace)::sum_splits(float const*)", "cat": "kernel",
         "ts": 370.0, "dur": 10.0, "tid": 7}]


def _slice(events, shapes=None, window=(0.0, 1000.0)):
    return types.SimpleNamespace(events=events, window=window, launch_shapes=shapes or {})


@pytest.fixture
def canned_work(monkeypatch):
    """The work record of `test_portbench_trace.py`'s readers."""
    work = canned_trace._Ctx(None).work
    monkeypatch.setattr(flops, "count", lambda model, flops_pass: work)


def context(sl, unit="portbench.train", units=2):
    return run.reader_context(sl, {"model": {}}, {"mode": "train", "batch": 1}, units, unit)


# Each reader's value on each canned slice at the parent commit, when the
# context held the reduction alone.
BEFORE = {
    ("trace", "device_idle_share.train"): 53.0,
    ("trace", "elementwise_ms.train"): 0.09000000000000001,
    ("trace", "conv_roofline.train"): 0.002695236170069402,
    ("trace", "step_mfu.train"): 0.0004042854255104103,
    ("phases", "device_idle_share.train"): 74.1,
    ("phases", "elementwise_ms.train"): 0.12000000000000001,
    ("phases", "conv_roofline.train"): None,
    ("phases", "step_mfu.train"): 0.0004042854255104103,
}


@pytest.mark.parametrize("canned,name", sorted(BEFORE), ids="-".join)
def test_existing_readers_read_as_before(canned_work, canned, name):
    events = {"trace": canned_trace.EVENTS, "phases": canned_phases.EVENTS}[canned]
    got = spec.metric_reader(name)(context(_slice(events)), None)
    want = BEFORE[canned, name]
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def test_graph_setup_reads_the_program_and_not_the_context(monkeypatch):
    fake = types.SimpleNamespace(totals=lambda: {"graph.eager": [1, 2.0],
                                                 "kernels.build": [1, 0.5]})
    monkeypatch.setitem(sys.modules, "jperceiver_tpu_torch.tracing", fake)
    assert spec.metric_reader("graph_setup_s")(None, None) == pytest.approx(2.5)


def _read(ctx, name):
    return spec.metric_reader(name)(ctx, {"name": name})


def test_new_readers_on_a_two_unit_slice(canned_work):
    ctx = context(_slice(canned_phases.EVENTS + CONV, SHAPES))
    # The canned steps' phases (`test_portbench_phases.py`), each with its
    # mark's microsecond; the K3/K4 kernels lie between the steps.
    want = {"forward": 41, "losses": 32, "cgt": 11, "backward": 31, "update": 11}
    for phase, us in want.items():
        assert _read(ctx, f"train_phase_ms.{phase}") == pytest.approx(us * 1e-3)
    assert _read(ctx, "replay_idle_ms.train") == pytest.approx(10e-3)
    assert _read(ctx, "replay_idle_ms.infer") == pytest.approx(10e-3)
    peaks = spec.peaks()
    flop = 2.0 * 512 * 512 * 64 * 64 * 9
    x = 64 * 512 * 512 * 4

    def bound(nbytes):
        return max(flop / peaks["tf32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])

    k3 = 3 * bound(2 * x + 64 * 64 * 9 * 4 + 4 * 64) + bound(2 * x + 64 * 64 * 9 * 4)
    assert _read(ctx, "k3_roofline.train") == pytest.approx(100 * k3 / 40e-6, rel=1e-9)
    assert _read(ctx, "k3_roofline.infer") == pytest.approx(100 * k3 / 40e-6, rel=1e-9)
    k4 = 2 * bound(2 * x + 4 * 64 * 64 * 9)
    assert _read(ctx, "k4_roofline.train") == pytest.approx(100 * k4 / 30e-6, rel=1e-9)


NEW = ["train_phase_ms.forward", "train_phase_ms.losses", "train_phase_ms.cgt",
       "train_phase_ms.backward", "train_phase_ms.update", "replay_idle_ms.train",
       "replay_idle_ms.infer", "k3_roofline.train", "k3_roofline.infer", "k4_roofline.train"]


def test_the_new_entries_are_the_new_readers():
    names = {m["name"] for m in spec.load_benchmark()["per_layer"]}
    assert set(NEW) <= names


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_without_marks_or_launches(canned_work, name):
    unmarked = [e for e in canned_phases.EVENTS + CONV if not e["name"].startswith("jp_mark_")]
    assert _read(context(_slice(unmarked)), name) is None
    # Marks but no launches counted: the rooflines read nothing, and the
    # phases still read.
    marked = context(_slice(canned_phases.EVENTS + CONV))
    if "roofline" in name:
        assert _read(marked, name) is None
    else:
        assert _read(marked, name) is not None


def test_breakdown_names_the_innermost_program_span(canned_work):
    ctx = context(_slice(canned_phases.EVENTS))
    gaps = dict(ctx.reduced.breakdown()["idle_gaps"])
    assert gaps == {"jp.graph.launch": pytest.approx(110e-6),
                    "portbench.slice": pytest.approx(353e-6),
                    "jp.train_step": pytest.approx(278e-6)}


def test_a_reader_file_dropped_in_reads_a_new_mark(canned_work, tmp_path):
    # A later configuration marks its depth trunk inside the forward
    # (`jp_mark_trunk` 5 us after `forward`, then `losses` as before): its
    # metric is a reader file and a BENCHMARK.json entry, nothing else.
    events = list(canned_phases.EVENTS)
    for t0 in (100.0, 600.0):
        events.append({"name": "jp_mark_trunk", "cat": "kernel", "ts": t0 + 5.0, "dur": 1.0,
                       "tid": 7})
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "trunk_ms.py").write_text(
        "def read(ctx, metric):\n    return ctx.phases.per_unit_ms('trunk')\n")
    bench = spec.load_benchmark()
    bench["per_layer"] = [{"name": "trunk_ms.train", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "model step",
                           "moves": "train_frames_per_s", "workloads": [TRAIN]}]
    ctx = context(_slice(events))
    got = run.per_layer(bench, TRAIN, ctx, root=tmp_path)
    # The trunk holds the forward's kernel from its mark on, 36 us; the
    # forward keeps its first 5 us (its mark and 4 of its kernel).
    assert got == {"trunk_ms.train": {"value": pytest.approx(36e-3), "unit": "ms"}}
    assert ctx.phases.per_unit_ms("forward") == pytest.approx(5e-3)
    assert ctx.phases.units == 2


def test_the_slice_traces_on_the_cpu(monkeypatch):
    import torch

    counts = {("conv3x3", "float32", 1, 8, 8, 4, 4, 1): 2}
    fake = types.SimpleNamespace(launch_shapes=lambda: dict(counts))
    monkeypatch.setitem(sys.modules, "jperceiver_tpu_torch.ops.cuda", fake)
    synced = []
    sl = run.Slice(lambda: synced.append(1), cuda=False)
    for _ in range(2):
        with sl.span("portbench.train"):
            torch.ones(64).add_(1)
            counts[("conv3x3", "float32", 1, 8, 8, 4, 4, 1)] += 3
            counts[("conv3x3_wgrad", "float32", 1, 8, 8, 4, 4, 1)] = 1
    assert sl.close() is sl
    assert len(synced) == 2  # one on opening, one on closing
    assert sl.launch_shapes == {("conv3x3", "float32", 1, 8, 8, 4, 4, 1): 6,
                                ("conv3x3_wgrad", "float32", 1, 8, 8, 4, 4, 1): 1}
    t0, t1 = sl.window
    units = [e for e in sl.events if e["name"] == "portbench.train"]
    assert len(units) == 2 and all(t0 <= e["ts"] <= t1 for e in units)
    assert len({e["tid"] for e in units}) == 1 and units[0]["tid"] is not None


def test_no_program_no_launches(monkeypatch):
    monkeypatch.delitem(sys.modules, "jperceiver_tpu_torch.ops.cuda", raising=False)
    assert run._launch_shapes() == {}
