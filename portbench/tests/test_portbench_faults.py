"""The check catches a broken timed path. Each test drives the rest of a
run on the CPU at 256^2 (past the harness's look for a card), with the
program broken underneath, and sees `correct` come out false under the
cell's own limits; the same run unbroken comes out true. The faults are
those each cell can have on one card: a training step that leaves its
state unchanged, half of the batch left out of the objective (the mean
over the rest; a cell of one row has no half to leave out), and an
answer altered where it is produced. The streaming driver, which no cell
of `BENCHMARK.json` uses yet, is run as a cell of its own here and its
altered pose read against its sound run."""

from __future__ import annotations

import pytest

from portbench import faults, run, spec

SMALL = dict(height=256, width=256, occ_map_size=64, cgt_label_hw=[94, 311])
STREAM = {"name": "stream.kitti_odom_1024", "config": "kitti_odom_1024",
          "traffic": "stream_clip65_chunk8", "chips": 1, "why": "streaming"}


@pytest.fixture
def small(monkeypatch):
    load_config, load_traffic = spec.load_config, spec.load_traffic

    def config(name, root=spec.HERE):
        cfg = load_config(name, root)
        cfg["model"].update(SMALL)
        return cfg

    def traffic(name, root=spec.HERE):
        t = dict(load_traffic(name, root))
        t.update({"train": {"batch": 2}, "infer": {"pool": 2, "sample": 2},
                  "stream": {"clip_frames": 9, "chunk": 4}}[t["driver"]])
        return t

    monkeypatch.setattr(spec, "load_config", config)
    monkeypatch.setattr(spec, "load_traffic", traffic)


def result(cell, controls=False):
    return run.run(cell, 2 ** 31 + 12345, 0.1, False, device="cpu", controls=controls,
                   log=lambda s: None)


def correct(cell):
    return result(cell)["correct"]


def test_sound_training_step_is_correct(small):
    assert correct("train.kitti_odom_1024")


@pytest.mark.parametrize("cell,fault", [
    ("train.kitti_odom_1024", "unchanged"), ("train.kitti_odom_1024", "half_batch"),
    ("infer.argo_both_1024", "altered_layout"), ("train.argo_both_1024", "unchanged")])
def test_the_fault_fails_and_the_sound_run_passes(small, cell, fault):
    if not cell.startswith("train"):
        assert correct(cell)
    with faults.FAULTS[fault]():
        assert not correct(cell)


def test_the_streaming_driver_reads_an_altered_pose(small, monkeypatch):
    bench = spec.load_benchmark()
    bench["workloads"].append(STREAM)
    monkeypatch.setattr(spec, "load_benchmark", lambda root=spec.ROOT: bench)
    monkeypatch.setattr(spec, "load_limits", lambda name, root=spec.HERE: {})
    sound = result(STREAM["name"], controls=True)["numbers"]
    with faults.altered_pose():
        altered = result(STREAM["name"], controls=True)["numbers"]
    assert altered["pose"] > 10 * sound["pose"]
    assert altered["disp"] == pytest.approx(sound["disp"])
