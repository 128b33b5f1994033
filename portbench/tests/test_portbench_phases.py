"""The reduction of the program's own tracing (`phases.py`) on a canned
trace: phase marks on the device, program and harness spans on two host
threads, and the K3/K4 launches the program counted by shape; and the
`graph_setup_s` reader over the program's timed set-up."""

from __future__ import annotations

import sys
import types

import pytest

from portbench import phases, spec, trace

# Two training steps in a slice of 1000 us, times in microseconds. Each
# step: forward 40, losses 20 + 10 around cgt 10, backward 30 with 10 idle
# inside, update 10; the marks 1 us each.
_UNIT = [("forward", 0), ("k", 1, 40), ("losses", 41), ("k", 42, 20), ("cgt", 62),
         ("k", 63, 10), ("losses", 73), ("k", 74, 10), ("backward", 84), ("k", 85, 10),
         ("k", 105, 20), ("update", 125), ("k", 126, 10), ("end", 136)]


def _device(t0):
    out = []
    for item in _UNIT:
        if item[0] == "k":
            out.append({"name": "void at::native::elementwise_kernel<4>", "cat": "kernel",
                        "ts": t0 + item[1], "dur": float(item[2]), "tid": 7})
        else:
            out.append({"name": "jp_mark_" + item[0], "cat": "kernel", "ts": t0 + item[1],
                        "dur": 1.0, "tid": 7})
    return out


def _span(name, ts, dur, tid):
    return {"name": name, "cat": "user_annotation", "ts": float(ts), "dur": float(dur),
            "tid": tid}


EVENTS = (
    [_span("portbench.slice", 0, 1000, 1),
     _span("portbench.train", 10, 400, 1), _span("jp.train_step", 12, 390, 1),
     _span("jp.graph.launch", 20, 300, 1),
     _span("portbench.train", 450, 500, 1), _span("jp.train_step", 455, 490, 1),
     # The prefetch thread, across an idle gap of the first step: ignored.
     _span("jp.prefetch.load", 190, 20, 2)]
    + _device(100) + _device(600)
    + [{"name": "Memcpy DtoD (Device -> Device)", "cat": "gpu_memcpy", "ts": 590.0,
        "dur": 5.0, "tid": 8}])


def test_phases_sum_their_segments_per_unit():
    p = phases.Phases(EVENTS, (0.0, 1000.0))
    assert p.marks[:8] == ["forward", "losses", "cgt", "losses", "backward", "update", "end",
                           "forward"]
    assert p.units == 2
    # Each phase holds its own mark's microsecond.
    assert p.per_unit_ms("forward") == pytest.approx(41e-3)
    assert p.per_unit_ms("losses") == pytest.approx((21 + 11) * 1e-3)
    assert p.per_unit_ms("cgt") == pytest.approx(11e-3)
    assert p.per_unit_ms("backward") == pytest.approx(31e-3)
    assert p.per_unit_ms("update") == pytest.approx(11e-3)
    assert p.per_unit_ms("end") is None
    total = sum(p.per_unit_ms(k) for k in ("forward", "losses", "cgt", "backward", "update"))
    # The unit's busy time less its end mark's.
    assert total == pytest.approx(1e-3 * (137 - 10) - 1e-3)
    # From the forward mark to the end of the end mark: 137 us, 10 of them idle.
    assert p.idle_ms() == pytest.approx(10e-3)
    assert p.unit_s == pytest.approx(2 * 137e-6)


def test_device_time_by_phase_and_class():
    p = phases.Phases(EVENTS, (0.0, 1000.0), spec.kernel_classes())
    got = p.class_ms()
    # The marks are a class of their own; the canned kernels elementwise.
    assert got["forward"] == {"marks": pytest.approx(1e-3), "elementwise": pytest.approx(40e-3)}
    assert got["losses"]["elementwise"] == pytest.approx(30e-3)
    assert got["backward"] == {"marks": pytest.approx(1e-3), "elementwise": pytest.approx(30e-3)}
    assert "end" not in got
    # The copy between the two steps starts in no phase.
    assert "memcpy" not in {c for by in got.values() for c in by}
    assert phases.Phases(EVENTS, (0.0, 1000.0)).class_ms() == {}


def test_a_slice_without_marks_reads_nothing():
    plain = [e for e in EVENTS if not e["name"].startswith("jp_mark_")]
    p = phases.Phases(plain, (0.0, 1000.0))
    assert p.units == 0 and p.marks == []
    assert p.per_unit_ms("forward") is None and p.idle_ms() is None


def test_idle_gaps_take_the_innermost_span_of_the_units_thread():
    tid = trace.unit_thread(EVENTS, "portbench.train")
    assert tid == 1
    gaps = trace.idle_gaps(EVENTS, (0.0, 1000.0), tid)
    # Each gap goes whole to the innermost span on thread 1 that holds its
    # middle: [0, 100] and [195, 205] to the first step's launch (not to the
    # prefetch thread's load around 200), [237, 590] between the steps to
    # the slice, [595, 600], [695, 705] and [737, 1000] to the second step.
    assert [(n, round(s * 1e6)) for n, s in gaps] == [
        ("portbench.slice", 353), ("jp.train_step", 263), ("jp.graph.launch", 100),
        ("jp.graph.launch", 10), ("jp.train_step", 10), ("jp.train_step", 5)]
    summed = trace.Reduced(EVENTS, (0.0, 1000.0), spec.kernel_classes(), 2, tid).breakdown()
    assert dict(summed["idle_gaps"]) == {"jp.graph.launch": pytest.approx(110e-6),
                                         "portbench.slice": pytest.approx(353e-6),
                                         "jp.train_step": pytest.approx(278e-6)}
    assert sum(s for _, s in gaps) == pytest.approx(1e-6 * (1000 - 2 * 127 - 5))
    assert {n for n, _ in trace.idle_gaps(EVENTS, (0.0, 1000.0), 99)} == {"outside a unit"}


def test_a_start_mark_inside_an_open_unit_does_not_reopen_it():
    # One unit: `forward` at 0, a second `forward` at 20 (19 us idle before
    # it), a kernel from 21 to 40, `end` at 40; marks 1 us each.
    events = [{"name": "jp_mark_" + n, "cat": "kernel", "ts": ts, "dur": dur, "tid": 7}
              for n, ts, dur in (("forward", 0.0, 1.0), ("forward", 20.0, 1.0),
                                 ("end", 40.0, 1.0))]
    events.append({"name": "k", "cat": "kernel", "ts": 21.0, "dur": 19.0, "tid": 7})
    p = phases.Phases(events, (0.0, 100.0))
    # The unit opens at the first mark: 41 us, 19 of them idle. Reopened at
    # the second it would read 21 us and no idle.
    assert p.units == 1
    assert p.unit_s == pytest.approx(41e-6)
    assert p.idle_ms() == pytest.approx(19e-3)
    assert p.per_unit_ms("forward") == pytest.approx(21e-3)


def test_a_unit_that_no_end_mark_closes_counts_nowhere():
    # The second step's `end` mark lost (as at a slice's edge): its phases
    # are not added to the first step's, which alone is read.
    events = [e for e in EVENTS if not (e["name"] == "jp_mark_end" and e["ts"] > 600)]
    p = phases.Phases(events, (0.0, 1000.0), spec.kernel_classes())
    assert p.units == 1
    assert p.per_unit_ms("forward") == pytest.approx(41e-3)
    assert p.per_unit_ms("losses") == pytest.approx(32e-3)
    assert p.class_ms()["backward"]["elementwise"] == pytest.approx(30e-3)
    assert p.idle_ms() == pytest.approx(10e-3)


def test_launch_work_is_the_kernel_tables_count():
    # chip_smoke.py's K3 row at 64 -> 64 channels, 512^2, pad 1, bf16, B = 1:
    # n_ops = 2 h w o 9 c, bytes (c hin win + o c 9 + o h w) * 2 + 4 o.
    flops, nbytes = phases.launch_work("conv3x3", "bfloat16", 1, 512, 512, 64, 64, 1)
    assert flops == 19_327_352_832 and nbytes == 67_182_848
    # Its K4 row: (c hin win + o h w) * 2 + 4 o c 9; the data-grad has no bias.
    flops, nbytes = phases.launch_work("conv3x3_wgrad", "bfloat16", 1, 512, 512, 64, 64, 1)
    assert flops == 19_327_352_832 and nbytes == 67_256_320
    assert phases.launch_work("conv3x3_dgrad", "bfloat16", 1, 512, 512, 64, 64, 1)[1] == \
        67_182_592
    # fp32 at B = 3, pad 0 (the output 2 smaller a side).
    flops, nbytes = phases.launch_work("conv3x3", "float32", 3, 10, 12, 4, 5, 0)
    assert flops == 2 * 3 * 8 * 10 * 4 * 5 * 9
    assert nbytes == (3 * 4 * 10 * 12 + 5 * 4 * 9 + 3 * 5 * 8 * 10) * 4 + 4 * 5


def test_conv_rooflines_from_counted_shapes():
    peaks = spec.peaks()
    shapes = {("conv3x3", "float32", 1, 512, 512, 64, 64, 1): 3,
              ("conv3x3_dgrad", "float32", 1, 512, 512, 64, 64, 1): 1,
              ("conv3x3_wgrad", "float32", 1, 512, 512, 64, 64, 1): 2}
    events = [{"name": "void f32k::conv3x3_f32(float const*)", "cat": "kernel", "ts": 0.0,
               "dur": 4000.0, "tid": 7},
              {"name": "void f32k::wgrad_f32(float const*)", "cat": "kernel", "ts": 4000.0,
               "dur": 1500.0, "tid": 7},
              {"name": "void (anonymous namespace)::sum_splits(float const*)",
               "cat": "kernel", "ts": 5500.0, "dur": 500.0, "tid": 7}]
    got = phases.conv_rooflines(events, (0.0, 6000.0), shapes, peaks)
    flops = 2.0 * 512 * 512 * 64 * 64 * 9
    dgrad_bytes = (64 * 512 * 512 * 2 + 64 * 64 * 9) * 4

    def bound(nbytes):
        return max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])

    k3 = 3 * bound(dgrad_bytes + 4 * 64) + bound(dgrad_bytes)  # the forward adds its bias
    assert got["k3"] == pytest.approx(100 * k3 / 4000e-6, rel=1e-9)
    k4 = max(flops / peaks["tf32_flops_per_s"],
             ((64 * 512 * 512 * 2) * 4 + 4 * 64 * 64 * 9) / peaks["hbm_bytes_per_s"])
    assert got["k4"] == pytest.approx(100 * 2 * k4 / 2000e-6, rel=1e-9)
    assert phases.conv_rooflines(events, (0.0, 6000.0), {}, peaks) == {"k3": None, "k4": None}


def test_marks_fall_in_no_class_that_a_metric_reads():
    classes = spec.kernel_classes()
    for m in ("forward", "losses", "cgt", "backward", "update", "end", "eval", "chunk"):
        assert spec.classify("jp_mark_" + m, "kernel", classes) == "marks"
        others = [c["name"] for c in classes if c["name"] != "marks"
                  and any(p.search("jp_mark_" + m) for p in c["compiled"])]
        assert others == []


def test_graph_setup_reader(monkeypatch):
    read = spec.metric_reader("graph_setup_s")
    monkeypatch.delitem(sys.modules, "jperceiver_tpu_torch.tracing", raising=False)
    assert read(None, None) is None  # a program without the timers
    fake = types.SimpleNamespace(totals=lambda: {
        "graph.eager": [2, 3.0], "graph.capture": [2, 1.5], "kernels.build": [1, 4.0],
        "fit.data_wait": [9, 100.0]})
    monkeypatch.setitem(sys.modules, "jperceiver_tpu_torch.tracing", fake)
    assert read(None, None) == pytest.approx(8.5)
    fake.totals = lambda: {}
    assert read(None, None) is None
