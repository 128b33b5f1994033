"""The FLOP and byte count of a unit on the meta device."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, spec
from portbench.reference import losses as L
from portbench.reference.model import ReferenceModel


def test_eval_forward_of_both_branches_is_543_8_gflop():
    """The port's `tools/complexity.py` counts 543.8 GFLOP for one 1024^2
    eval forward of both branches with pose (its method, this model)."""
    m = dict(spec.load_config("argo_both_1024")["model"], frame_ids=[0, -1, 1])
    rec = flops.count(m, {"mode": "eval", "batch": 1})
    assert rec.flops == pytest.approx(543.8e9, rel=2e-4)
    with torch.device("meta"):
        model = ReferenceModel(256, "both").eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty(1, 3, 3, 1024, 1024, device="meta"), with_pose=True)
    assert rec.flops == counter.get_total_flops()


@pytest.mark.parametrize("name", ["kitti_odom_1024", "argo_both_1024"])
def test_training_step_counts_forward_and_backward_once(name):
    m = spec.load_config(name)["model"]
    rec = flops.count(m, {"mode": "train", "batch": 3})
    with torch.device("meta"):
        model = ReferenceModel(256, "both" if m["type"] == "Argo_both" else "road",
                               tuple(m["frame_ids"])).train()
    batch = flops._meta_batch(m, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        out = model(batch["color_aug"], with_pose=True)
        sum(L.losses(out, batch, m, None).values()).backward()
    assert rec.flops == counter.get_total_flops()
    # Forward and backward: about three forwards of the batch.
    forward = flops.count(m, {"mode": "eval", "batch": 3}).flops
    assert 2.8 * forward < rec.flops < 3.2 * forward
    assert all(moved > 0 for _, _, moved in rec.ops)


def test_stream_call_is_its_frames_times_a_frame():
    m = spec.load_config("kitti_odom_1024")["model"]
    one = flops.count(m, {"mode": "stream", "frames": 1})
    many = flops.count(m, {"mode": "stream", "frames": 64})
    assert many.flops == 64 * one.flops


def test_roofline_takes_the_larger_bound_of_each_op():
    rec = flops.WorkRecord()
    rec.ops = [("conv", 989 * 10 ** 9, 1), ("mm", 1, 3350 * 10 ** 6)]
    assert flops.roofline_seconds(rec, 989e12, 3.35e12, 2) == pytest.approx(1e-3 + 2e-3)
