"""The port's tracing (`jperceiver_tpu_torch/tracing.py`) on the CPU.

Spans cost one flag read and record nothing while no profiler records, and
are `jp.<name>` records under one; timed events keep their seconds, an
inner event counted once; marks do nothing off the card and name the
kernels of `csrc/marks.cu` in order. The training step, the eval step and
the epoch loop give their spans, nested as `tracing.py` lists them, under
`torch.profiler` (the graphs are a stand-in here: a capture runs the body,
a replay nothing), and the same numbers with and without a profiler. The
K3/K4 launches by shape stay exact across a capture and its replays.
"""

import contextlib
import copy
import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from jperceiver_tpu_torch import tracing
from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine import (Trainer, TrainStep, graphs, infer, make_eval_step,
                                         make_train_step)
from jperceiver_tpu_torch.engine import trainer as trainer_mod
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.ops import cuda as kernels
from jperceiver_tpu_torch.ops.cuda import _build, conv3x3

H = 128
CFG = dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
           height=H, width=H, occ_map_size=H // 4, num_class=2, min_depth=0.1,
           max_depth=100.0, automask=True, disp_norm=True, loss_type="iou", loss_sum=3,
           loss_weight=20, loss2_weight=20, cgt_label_hw=(375, 1242),
           optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
           optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
           lr_config=dict(policy="step", step=[1]))
MARKS_CU = (Path(_build.__file__).parent / "csrc" / "marks.cu").read_text()
# Every mark the entry points launch, in the order `marks.cu` defines them.
MARKS = ("forward", "losses", "cgt", "backward", "update", "end", "eval", "chunk")


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.replays += 1


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """CUDA graphs on the CPU: a capture runs the body, a replay nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof, tmp_path) -> list[dict]:
    """The trace's `jp.*` spans, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("jp.")]
    return sorted(spans, key=lambda e: (e["ts"], -e["dur"]))


def _parent(spans, child) -> str | None:
    """The innermost span on the child's thread that holds it."""
    holding = [s for s in spans if s is not child and s["tid"] == child["tid"]
               and s["ts"] <= child["ts"] and child["ts"] + child["dur"] <= s["ts"] + s["dur"]]
    return min(holding, key=lambda s: s["dur"])["name"] if holding else None


def _children(spans, parent) -> list[str]:
    return [s["name"] for s in spans if s is not parent and s["tid"] == parent["tid"]
            and parent["ts"] <= s["ts"] <= parent["ts"] + parent["dur"]
            and _parent(spans, s) == parent["name"]]


def test_span_costs_a_flag_read_and_records_nothing_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or contextlib.nullcontext())
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("train_step") as s:
        assert s is None
    assert made == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with tracing.span("train_step"):
        pass
    assert made == ["jp.train_step"]


def test_spans_nest_in_a_profiler_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(3).add_(1)
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = _spans(prof, tmp_path)
    assert [s["name"] for s in spans] == ["jp.outer", "jp.inner"]
    assert _parent(spans, spans[1]) == "jp.outer"


def test_timed_counts_an_inner_event_once():
    """An event inside another on its thread counts once, in the inner one;
    an event on another thread meanwhile is no inner event."""
    tracing.reset_totals()
    elsewhere = []

    def other_thread():
        with tracing.timed("graph.capture") as event:
            time.sleep(0.01)
        elsewhere.append(event)

    with tracing.timed("graph.eager") as outer:
        thread = threading.Thread(target=other_thread)
        thread.start()
        thread.join(timeout=10)
        with tracing.timed("kernels.build") as inner:
            time.sleep(0.02)
    assert not thread.is_alive() and len(elsewhere) == 1
    totals = tracing.totals()
    assert outer.seconds > inner.seconds >= 0.02
    assert totals["kernels.build"] == [1, inner.seconds]
    assert totals["graph.capture"] == [1, elsewhere[0].seconds]
    assert totals["graph.eager"] == [1, pytest.approx(outer.seconds - inner.seconds, abs=1e-12)]
    assert sum(s for _, s in totals.values()) == pytest.approx(
        outer.seconds + elsewhere[0].seconds)
    tracing.reset_totals()
    assert tracing.totals() == {}


def test_the_kernel_library_build_is_timed(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    def refused(**kw):
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(ext, "load", refused)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    tracing.reset_totals()
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.library()
    assert tracing.totals()["kernels.build"][0] == 1


@pytest.mark.parametrize("name", MARKS)
def test_a_mark_does_nothing_off_the_card(monkeypatch, name):
    monkeypatch.setattr(_build, "marks_library", lambda: pytest.fail("built the marks"))
    tracing.mark(name, torch.device("cpu"))
    tracing.mark(name, torch.device("meta"))


@pytest.fixture
def stand_in_card(monkeypatch):
    """A CUDA device's current stream on the CPU: 1000 + its index."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a stand-in card")
    monkeypatch.setattr(tracing, "_unmarked", False)


def test_a_mark_on_the_card_launches_its_kernel(monkeypatch, stand_in_card):
    """The launch `mark` makes for a CUDA device (the marks' library a
    stand-in, the kernel library never built): the mark's own launcher on
    the device's current stream; an error the launch returns raises, as
    does a mark `marks.cu` does not define."""
    calls, errors = [], []

    class Lib:
        def __getattr__(self, fn):
            if not fn.startswith("jp_mark_launch_") or fn[15:] not in MARKS:
                raise AttributeError(fn)
            return lambda stream: calls.append((fn, stream)) or (errors.pop() if errors else 0)

    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built the kernel library"))
    monkeypatch.setattr(_build, "marks_library", Lib)
    _build.mark_launcher.cache_clear()
    try:
        for name in MARKS:
            tracing.mark(name, torch.device("cuda", 1))
        assert calls == [("jp_mark_launch_" + m, 1001) for m in MARKS]
        errors.append(1)
        with pytest.raises(RuntimeError, match="mark cgt: CUDA error 1"):
            tracing.mark("cgt", torch.device("cuda", 0))
        with pytest.raises(ValueError, match="no phase mark 'clip'"):
            tracing.mark("clip", torch.device("cuda", 0))
    finally:
        _build.mark_launcher.cache_clear()


def test_marks_that_cannot_be_built_warn_once_and_stay_off(monkeypatch, stand_in_card):
    tries = []

    def refused():
        tries.append(1)
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(_build, "marks_library", refused)
    with pytest.warns(RuntimeWarning, match="phase marks are off.*no nvcc here"):
        tracing.mark("forward", torch.device("cuda", 0))
    for name in MARKS:
        tracing.mark(name, torch.device("cuda", 0))
    assert tries == [1]


def test_marks_name_the_kernels_of_marks_cu_in_order():
    """Each mark is one `JP_MARK` of `marks.cu`, every mark the package
    launches among them, and the kernel library builds none of them."""
    assert re.findall(r"^JP_MARK\((\w+)\)$", MARKS_CU, re.M) == list(MARKS)
    package = Path(tracing.__file__).parent
    launched = {m for f in package.rglob("*.py")
                for m in re.findall(r'\bmark\("(\w+)"', f.read_text())}
    assert launched == set(MARKS)
    assert "marks.cu" not in _build.SOURCES
    assert not any("mark" in name for name in _build._SIGNATURES)


@pytest.fixture(scope="module")
def train_runs(one_thread, tmp_path_factory):
    """The 128^2 step three times under a profiler, as a stand-in graph
    (an eager warm-up, a capture and a replay), and once eagerly without
    one from the same state: the spans, and the first step's metrics and
    weights of both."""
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=H, occ_map_size=H // 4, branches="road")
    init = copy.deepcopy(model.state_dict())
    batch = synthetic_batch(1, H, H, H // 4, seed=0)
    plain = make_train_step(model, CFG, "cpu", steps_per_epoch=2, seed=3)
    want = {k: v.clone() for k, v in plain(batch).items()}
    want_params = [p.detach().clone() for p in plain.params]

    model.load_state_dict(init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
        mp.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
        mp.setattr(trainer_mod, "use_graphs", lambda *a, **kw: True)
        step = make_train_step(model, CFG, "cpu", steps_per_epoch=2, seed=3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            first = {k: v.clone() for k, v in step(batch).items()}
            first_params = [p.detach().clone() for p in step.params]
            step(batch)
            step(batch)
    spans = _spans(prof, tmp_path_factory.mktemp("train"))
    return spans, (want, want_params), (first, first_params), step


def test_train_step_spans_nest(train_runs):
    spans, _, _, step = train_runs
    steps = [s for s in spans if s["name"] == "jp.train_step"]
    assert len(steps) == 3 and all(_parent(spans, s) is None for s in steps)
    assert [_children(spans, s) for s in steps] == [
        ["jp.train_step.inputs", "jp.graph.eager", "jp.train_step.grads"],
        ["jp.train_step.inputs", "jp.graph.capture", "jp.graph.launch", "jp.train_step.grads"],
        ["jp.train_step.inputs", "jp.graph.copy_in", "jp.graph.launch", "jp.train_step.grads"]]
    (captured,) = step.graphs.entries.values()
    assert (step.graphs.eager_calls, step.graphs.captures, captured.graph.replays) == (1, 1, 2)


def test_train_step_is_the_same_under_a_profiler(train_runs):
    _, (want, want_params), (got, got_params), _ = train_runs
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(got_params, want_params, strict=True))


def test_eval_step_spans_nest_and_outputs_match(one_thread, stand_in_graphs, monkeypatch,
                                                tmp_path):
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=H, occ_map_size=H // 4, branches="road")
    frames = synthetic_batch(1, H, H, H // 4, seed=1)["color_aug"]
    want = make_eval_step(model, CFG, "cpu")({"color_aug": frames})
    monkeypatch.setattr(infer, "use_graphs", lambda *a, **kw: True)
    step = make_eval_step(model, CFG, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = {k: v.clone() for k, v in step({"color_aug": frames}).items()}
        for _ in range(2):
            step({"color_aug": frames})
    assert all(torch.equal(got[k], want[k]) for k in want)
    spans = _spans(prof, tmp_path)
    calls = [s for s in spans if s["name"] == "jp.eval_step"]
    assert [_children(spans, s) for s in calls] == [
        ["jp.eval_step.upload", "jp.graph.eager"],
        ["jp.eval_step.upload", "jp.graph.capture", "jp.graph.launch"],
        ["jp.eval_step.upload", "jp.graph.copy_in", "jp.graph.launch"]]


def test_capture_seconds_are_the_timed_capture(stand_in_graphs):
    tracing.reset_totals()
    cache = graphs.GraphCache(lambda x: {"y": x + 1}, "the test body")
    for _ in range(3):
        cache.run("k", {"x": torch.ones(2)})
    totals = tracing.totals()
    assert cache.capture_s == [totals["graph.capture"][1]]
    assert totals["graph.eager"][0] == cache.eager_calls == 1
    assert (cache.captures, cache.entries["k"].graph.replays) == (1, 2)


class _StandInStep:
    reduce_metrics = staticmethod(TrainStep.reduce_metrics)

    def __call__(self, batch):
        return {"loss": torch.zeros(())}


def _trainer(**kw):
    """A `Trainer` over 16 batches whose step is a stand-in."""
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=H, occ_map_size=H // 4, branches="road")
    cfg = {"model": CFG, **{k: CFG[k] for k in ("optimizer", "optimizer_config",
                                                 "lr_config")}}
    loader = [{"color": np.zeros((1,), np.float32)}] * 16
    trainer = Trainer(model, cfg, loader, steps_per_epoch=16, device="cpu", log_interval=1,
                      **kw)
    trainer.train_step = _StandInStep()
    return trainer


def test_fit_spans_and_data_waits(tmp_path):
    """The loop's spans on its thread and the prefetch thread's on its own,
    and `data_wait_s` as `fit.data_wait` timed it."""
    trainer = _trainer(checkpoint_fn=lambda step, epoch: None,
                       eval_hook=lambda step, epoch: {"abs_rel": 0.5})
    tracing.reset_totals()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        trainer.fit(1)
    waits = trainer.data_wait_s[0]
    assert len(waits) == 17  # 16 batches, then the end
    assert tracing.totals()["fit.data_wait"] == [17, pytest.approx(sum(waits), rel=1e-12)]
    spans = _spans(prof, tmp_path)
    fit = [s for s in spans if s["name"].startswith("jp.fit.")]
    assert {s["name"] for s in fit} == {"jp.fit.data_wait", "jp.fit.log", "jp.fit.checkpoint",
                                        "jp.fit.eval"}
    assert len({s["tid"] for s in fit}) == 1
    prefetch = [s for s in spans if s["name"].startswith("jp.prefetch.")]
    assert [s["name"] for s in prefetch].count("jp.prefetch.load") == 16
    assert [s["name"] for s in prefetch].count("jp.prefetch.upload") == 16
    assert {s["tid"] for s in prefetch}.isdisjoint({fit[0]["tid"]})


def test_profile_dir_holds_every_threads_spans(tmp_path):
    _trainer(profile_dir=str(tmp_path)).fit(1)
    events = json.loads((tmp_path / "steps_10_14.trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"jp.fit.data_wait", "jp.fit.log", "jp.prefetch.load", "jp.prefetch.upload"} <= names


def test_launch_shapes_across_capture_and_replays(stand_in_graphs):
    """A body that counts two K3 launches and one K4 launch as the
    wrappers do: the warm-up counts them by shape, a capture none, each
    replay the captured ones; a failed capture leaves them as they were;
    a reset empties them."""
    def body(x):
        for _ in range(2):
            conv3x3._count("conv3x3", torch.float32, 3, 64, 64, 48, 64, 1)
        conv3x3._count("conv3x3_wgrad", torch.bfloat16, 3, 64, 64, 48, 64, 1)
        return {"y": x * 2}

    fwd = ("conv3x3", "float32", 3, 64, 64, 48, 64, 1)
    wg = ("conv3x3_wgrad", "bfloat16", 3, 64, 64, 48, 64, 1)
    kernels.reset_launch_counts()
    cache = graphs.GraphCache(body, "the test body")
    cache.run("k", {"x": torch.ones(2)})
    assert kernels.launch_shapes() == {fwd: 2, wg: 1}
    cache.run("k", {"x": torch.ones(2)})  # capture + replay
    assert kernels.launch_shapes() == {fwd: 4, wg: 2}
    assert cache.entries["k"].launches.per_replay_shapes == {fwd: 2, wg: 1}
    cache.run("k", {"x": torch.ones(2)})
    assert kernels.launch_shapes() == {fwd: 6, wg: 3}
    assert kernels.launch_counts()["conv3x3"] == 6 and kernels.launch_counts()[
        "conv3x3_wgrad"] == 3

    def failing(x):
        conv3x3._count("conv3x3_dgrad", torch.float32, 1, 8, 8, 4, 4, 1)
        raise RuntimeError("operation not permitted when stream is capturing")

    bad = graphs.GraphCache(failing, "the failing body")
    bad.entries["k"], bad.eager_calls = None, 1  # warmed up
    with pytest.raises(RuntimeError, match="capture of the failing body failed"):
        bad.run("k", {"x": torch.ones(2)})
    assert kernels.launch_shapes() == {fwd: 6, wg: 3}
    kernels.reset_launch_counts()
    assert kernels.launch_shapes() == {}
