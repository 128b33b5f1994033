"""The plain reference against the program's eager fp32 training step and
eval step, at 256^2 on the CPU (the smallest size whose BEV features are
wider than one pixel, so that BatchNorm's batch statistics are not
degenerate), from the same weights, batch and random draws; and the
structure (trunk depths, branches) the reference reads from a
configuration."""

from __future__ import annotations

import statistics

import pytest
import torch

from portbench import data, spec
from portbench.reference import losses as L
from portbench.reference import train as ref

SMALL = dict(height=256, width=256, occ_map_size=64, cgt_label_hw=[94, 311])
# Each case: a configuration and what it changes. `.resnet50` is
# kitti_odom_1024 with ResNet-50 depth, layout and pose trunks.
CASES = {"kitti_odom_1024": ("kitti_odom_1024", {}),
         "argo_both_1024": ("argo_both_1024", {}),
         "kitti_odom_1024.resnet50": ("kitti_odom_1024",
                                      dict(depth_num_layers=50, pose_num_layers=50))}


def small_cfg(case):
    name, changes = CASES[case]
    cfg = spec.load_config(name)
    cfg["model"].update(SMALL, **changes)
    return cfg


@pytest.fixture
def one_thread():
    """One intra-op thread: the case reads the same on every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The worst parameter's gradient gap. argo_both_1024's two frames put its
# worst parameters (the depth decoder's last convolutions, the layout
# encoder's BatchNorm shifts) 5e-3 from a float64 witness of the reference
# on this seed, in the fp32 reference and the program alike: fp32's own
# rounding of those cancelling sums. At ResNet-50 the trunks' training
# BatchNorm carries the rounding of 16 bottlenecks: on this seed the fp32
# reference lies 0.014 from a float64 witness (the depth trunk's layer2
# BatchNorm) and the program 0.023 (the CCT's query and key convolutions),
# so the two may lie their sum, 0.037, apart; they read 0.021.
WORST = {"kitti_odom_1024": 2e-3, "argo_both_1024": 1e-2, "kitti_odom_1024.resnet50": 4e-2}


@pytest.mark.parametrize("case", list(CASES))
def test_one_training_step_matches_the_program(case, one_thread):
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.models import build_model

    cfg = small_cfg(case)
    m = cfg["model"]
    dev = torch.device("cpu")
    weights = data.make_weights(ref.shapes(m), 3, dev)
    model = build_model(dict(m))
    model.load_state_dict(weights, strict=True)
    step = make_train_step(model, m, dev, steps_per_epoch=1000, seed=17, optim_cfg=cfg)
    batch = data.train_batch(m, 2, 3, 0, dev)
    got_loss = float(step(batch)["loss"])
    b1 = step.optimizer.betas[0]
    names = [n for n, p in model.named_parameters()]
    got = {n: float(step.optimizer.state[p]["mu"].norm()) / (1 - b1)
           for n, p in zip(names, step.params)}

    want = ref.train_readings(ref.build(m, weights, dev), cfg, [batch], 17, dev)
    assert got_loss == pytest.approx(want["loss"][0], rel=2e-5)
    floor = statistics.median(want["grad"].values())
    worst = max(abs(got[n] - want["grad"][n]) / max(want["grad"][n], floor) for n in got)
    assert worst < WORST[case]


@pytest.mark.parametrize("case", ["argo_both_1024", "kitti_odom_1024.resnet50"])
def test_eval_outputs_match_the_program(case, one_thread):
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import build_model

    m = small_cfg(case)["model"]
    dev = torch.device("cpu")
    weights = data.make_weights(ref.shapes(m), 4, dev)
    model = build_model(dict(m))
    model.load_state_dict(weights, strict=True)
    frames = data.frames((1, len(m["frame_ids"]), 3, 256, 256), 4, 0, dev)[1]
    got = make_eval_step(model, m, dev)({"color_aug": frames})
    want = ref.eval_outputs(ref.build(m, weights, dev), frames)
    poses = [f"cam_T_cam/{f}" for f in m["frame_ids"][1:]]
    assert poses == {"argo_both_1024": ["cam_T_cam/-1"],
                     "kitti_odom_1024.resnet50": ["cam_T_cam/-1", "cam_T_cam/1"]}[case]
    layouts = {"road": ("topview",), "both": ("topview", "topviewB")}[ref.structure(m)[2]]
    for key in ("disp/0", *layouts, *poses):
        scale = want[key].norm()
        assert float((got[key] - want[key]).norm() / scale) < 1e-4, key


@pytest.mark.parametrize("changes, key", [
    (dict(type="dynamic"), "type"),
    (dict(type="Argo_dynamic"), "type"),
    (dict(depth_num_layers=20), "depth_num_layers"),
    (dict(pose_num_layers=20), "pose_num_layers"),
])
def test_structure_raises_for_what_the_reference_cannot_compute(changes, key):
    m = dict(spec.load_config("kitti_odom_1024")["model"], **changes)
    with pytest.raises(ValueError, match=f"^{key} = "):
        ref.structure(m)


def test_structure_follows_the_model_keys():
    kitti = spec.load_config("kitti_odom_1024")["model"]
    argo = spec.load_config("argo_both_1024")["model"]
    assert ref.structure(kitti) == (18, 18, "road")
    assert ref.structure(argo) == (18, 18, "both")
    assert ref.structure(dict(kitti, depth_num_layers=50, pose_num_layers=34)) == (50, 34, "road")
    assert ref.structure(dict(kitti, skip_inactive_branch=False)) == (18, 18, "both")
    del kitti["depth_num_layers"], kitti["pose_num_layers"]
    assert ref.structure(kitti) == (18, 18, "road")


def test_cgt_label_matches_the_program_at_full_size():
    from jperceiver_tpu_torch.losses.cgt import cgt_scale_label

    for name in ("kitti_odom_1024", "argo_both_1024"):
        m = spec.load_config(name)["model"]
        road, _ = data.bev_layouts(3, m["occ_map_size"], 11, 0)
        b = data.intrinsics(3, m["height"], m["width"], "cpu")
        kind = "static" if m["type"] == "static" else "both"
        layout = torch.from_numpy(road) if kind == "static" else torch.from_numpy(road).float()
        args = (b["odometry_K"][:, :3, :3], b["Tr_cam2_velo"])
        got = cgt_scale_label(layout, *args, kind=kind, split=m["split"],
                              occ_map_size=m["occ_map_size"], out_hw=tuple(m["cgt_label_hw"]))
        want = L.cgt_label(layout, *args, kind, m["split"], m["occ_map_size"],
                           tuple(m["cgt_label_hw"]))
        assert float((want > 0).float().mean()) > 0.02  # the scale loss has support
        assert float((got - want).norm() / want.norm()) < 1e-4
