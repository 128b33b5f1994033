"""The FLOP and byte count of a unit on the meta device."""

from __future__ import annotations

import hashlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, spec
from portbench.reference import losses as L
from portbench.reference import train as ref

RESNET50 = dict(depth_num_layers=50, pose_num_layers=50)


def test_eval_forward_of_both_branches_is_543_8_gflop():
    """The port's `tools/complexity.py` counts 543.8 GFLOP for one 1024^2
    eval forward of both branches with pose (its method, this model)."""
    m = dict(spec.load_config("argo_both_1024")["model"], frame_ids=[0, -1, 1])
    rec = flops.count(m, {"mode": "eval", "batch": 1})
    assert rec.flops == pytest.approx(543.8e9, rel=2e-4)
    model = ref.meta_model(m).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty(1, 3, 3, 1024, 1024, device="meta"), with_pose=True)
    assert rec.flops == counter.get_total_flops()


@pytest.mark.parametrize("name", ["kitti_odom_1024", "argo_both_1024", "kitti_odom_1024.resnet50"])
def test_training_step_counts_forward_and_backward_once(name):
    config, _, variant = name.partition(".")
    m = dict(spec.load_config(config)["model"], **(RESNET50 if variant else {}))
    rec = flops.count(m, {"mode": "train", "batch": 3})
    model = ref.meta_model(m).train()
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


def test_resnet50_eval_forward_counts_what_flop_counter_counts():
    m = dict(spec.load_config("kitti_odom_1024")["model"], **RESNET50)
    rec = flops.count(m, {"mode": "eval", "batch": 1})
    model = ref.meta_model(m).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty(1, 3, 3, 1024, 1024, device="meta"), with_pose=True)
    assert rec.flops == counter.get_total_flops()
    # The ResNet-50 trunks are more work than ResNet-18's.
    assert rec.flops > flops.count(spec.load_config("kitti_odom_1024")["model"],
                                   {"mode": "eval", "batch": 1}).flops


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# The records of the configurations the benchmark's cells run, as the
# reference gave them while it was written for ResNet-18 alone: the
# state dict's entries (names, shapes, order: `data.make_weights` draws
# in that order) and each pass's FLOPs, elements moved and op count,
# with a digest of its (op, FLOPs, elements) list in order.
PINNED = {
    "kitti_odom_1024": {
        "shapes": (586, "8a15e042881b45e4"),
        "train1": (1602895460416, 2064473428, 386, "2b1c51f21e836b76"),
        "train3": (4808686381104, 5827111182, 386, "ce794f2ba671dc2f"),
        "eval1": (538103070976, 707154912, 162, "b97c1cce86a5e001"),
        "stream64": (33812950548480, 43687840384, 136, "801736878baefe69"),
    },
    "argo_both_1024": {
        "shapes": (756, "9a6c02509c008fb7"),
        "train1": (1591559344236, 1962269321, 393, "cc2aa31417ac7c77"),
        "train3": (4774678032708, 5543579255, 393, "a35b0120b85afa88"),
        "eval1": (534037241984, 701170846, 175, "78a82de955b6b7ac"),
        "stream64": (34178383478784, 44874931072, 174, "20abf06f72492abb"),
    },
}
PASSES = {"train1": {"mode": "train", "batch": 1}, "train3": {"mode": "train", "batch": 3},
          "eval1": {"mode": "eval", "batch": 1}, "stream64": {"mode": "stream", "frames": 64}}


@pytest.mark.parametrize("name", list(PINNED))
def test_cells_configurations_keep_their_records(name):
    m = spec.load_config(name)["model"]
    shapes = ref.shapes(m)
    assert (len(shapes), _digest(";".join(f"{k}:{tuple(v)}" for k, v in shapes.items()))) \
        == PINNED[name]["shapes"]
    for key, unit in PASSES.items():
        rec = flops.count(m, unit)
        got = (rec.flops, sum(e for _, _, e in rec.ops), len(rec.ops), _digest(repr(rec.ops)))
        assert got == PINNED[name][key], key


def test_stream_call_is_its_frames_times_a_frame():
    m = spec.load_config("kitti_odom_1024")["model"]
    one = flops.count(m, {"mode": "stream", "frames": 1})
    many = flops.count(m, {"mode": "stream", "frames": 64})
    assert many.flops == 64 * one.flops


def test_roofline_takes_the_larger_bound_of_each_op():
    rec = flops.WorkRecord()
    rec.ops = [("conv", 989 * 10 ** 9, 1), ("mm", 1, 3350 * 10 ** 6)]
    assert flops.roofline_seconds(rec, 989e12, 3.35e12, 2) == pytest.approx(1e-3 + 2e-3)
