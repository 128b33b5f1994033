"""The port's tools on the CPU (`--device cpu`).

- `tools/acceptance` at 128^2 (4 simulated scenes, one epoch of two B=2
  steps, a 110-frame drive): `acceptance.json` with the JAX tool's keys (its
  odometry keys are those the JAX tool keeps of the JAX `KittiOdomEval` on
  the same files), the epoch restored, finite metrics, one 100 m segment;
- `tools/eval_depth` on that checkpoint: its row equals the `EvalHook`'s
  depth metrics on the same split within 1e-6 relative;
- `tools/make_splits` (every kind) writes the JAX tool's files from the
  same trees; `tools/plot_trajectory` gives the JAX tool's ATEs within
  1e-12 relative;
- `tools/video_demo` (cv2) writes one composite frame a frame pair.
"""

import json
import os

import numpy as np
import pytest
import torch

from jperceiver_tpu.engine.eval_hook import DEPTH_KEYS as JAX_DEPTH_KEYS
from jperceiver_tpu.evaluation.kitti_odometry import KittiOdomEval as JaxKittiOdomEval
from jperceiver_tpu.tools import make_splits as jax_make_splits
from jperceiver_tpu.tools import plot_trajectory as jax_plot_trajectory
from jperceiver_tpu_torch.config import Config
from jperceiver_tpu_torch.data import DataLoader, get_dataset
from jperceiver_tpu_torch.engine.checkpoint import load_weights
from jperceiver_tpu_torch.engine.eval_hook import EvalHook
from jperceiver_tpu_torch.evaluation.trajectory import save_kitti_poses
from jperceiver_tpu_torch.evaluation.transforms import se3_exp
from jperceiver_tpu_torch.models import JPerceiver, build_model
from jperceiver_tpu_torch.tools import acceptance, eval_depth, make_splits, plot_trajectory
from jperceiver_tpu_torch.tools import video_demo

H = 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tools' loader threads run PyTorch ops beside
    the model's, and with a thread pool per op apiece they oversubscribe a
    CPU that other test processes share (the acceptance run took 45 times
    its time alone in a parallel test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def accepted(tmp_path_factory):
    wd = tmp_path_factory.mktemp("acc")
    res = acceptance.main(["--work_dir", str(wd), "--height", str(H), "--n_scenes", "4",
                           "--imgs_per_gpu", "2", "--epochs", "1", "--odom_frames", "110",
                           "--device", "cpu"])
    return wd, res


def test_acceptance_has_the_jax_tools_keys(accepted):
    wd, res = accepted
    assert json.load(open(wd / "acceptance.json")) == json.loads(json.dumps(res))
    assert sorted(res) == ["config", "eval", "odometry", "restored_epoch", "type"]
    assert res["restored_epoch"] == 1 and res["type"] == "static"
    assert sorted(res["eval"]) == sorted(JAX_DEPTH_KEYS + ["road_iou", "road_map",
                                                          "n_eval_samples", "fps"])
    assert res["eval"]["n_eval_samples"] == 4
    assert all(np.isfinite(v) for v in res["eval"].values())
    ref = JaxKittiOdomEval(str(wd / "gt_pose"), str(wd / "odom")).eval_sequence("21")
    assert sorted(res["odometry"]) == sorted(k for k, v in ref.items()
                                             if isinstance(v, (int, float)))
    assert res["odometry"]["n_segments"] >= 1 and np.isfinite(res["odometry"]["t_rel_percent"])
    assert (wd / "odom" / "21.txt").is_file() and (wd / "odom" / "21.png").is_file()


def test_eval_depth_equals_the_hooks_depth_metrics(accepted, capsys):
    wd, _ = accepted
    cfg_path = str(wd / "sim_acceptance.py")
    row = eval_depth.main(["--config", cfg_path, "--checkpoint", str(wd), "--device", "cpu"])
    assert "abs_rel" in capsys.readouterr().out
    cfg = Config.fromfile(cfg_path)
    model = build_model(cfg.model)
    load_weights(str(wd), model)
    loader = DataLoader(get_dataset(cfg.data, training=False), batch_size=1, shuffle=False,
                        num_workers=2, drop_last=False)
    want = EvalHook(model, loader, cfg.model, with_layout=False, device="cpu")()
    for got, k in zip(row, eval_depth.METRICS):
        assert abs(got - want[k]) <= 1e-6 * abs(want[k]), (k, got, want[k])


def _trees(root):
    """Fake KITTI odometry/object/poses/cityscapes trees."""
    for seq, n in (("00", 3), ("01", 2), ("09", 2), ("10", 1)):
        d = root / "odo" / seq / "road_dense128"
        os.makedirs(d)
        for i in range(n):
            (d / f"{i:06d}.png").write_bytes(b"")
    d = root / "obj" / "training" / "vehicle_256"
    os.makedirs(d)
    for i in (5, 1, 9, 3, 7, 2, 4, 8, 6, 0, 11):
        (d / f"{i:06d}.png").write_bytes(b"")
    os.makedirs(root / "poses")
    for seq in ("00", "01"):
        (root / "poses" / f"{seq}.txt").write_text(f"{seq} pose rows\n")
    for split in ("train", "val", "test"):
        d = root / "city" / "leftImg8bit_sequence" / split / "aachen"
        os.makedirs(d)
        (d / f"aachen_{split}_000001.png").write_bytes(b"")


def _files(d):
    return {os.path.relpath(os.path.join(r, f), d): open(os.path.join(r, f)).read()
            for r, _, fs in os.walk(d) for f in fs}


@pytest.mark.parametrize("kind,data,extra", [
    ("odometry", "odo", ["--train_seqs", "00", "01", "--val_seqs", "09", "10"]),
    ("object", "obj", ["--val_fraction", "0.2"]),
    ("gt_pose", "poses", []),
    ("cityscape", "city", []),
    ("shot_sequence", "odo", [])])
def test_make_splits_writes_the_jax_tools_files(kind, data, extra, tmp_path):
    _trees(tmp_path)
    for mod, out in ((make_splits, "port"), (jax_make_splits, "jax")):
        mod.main([kind, "--data", str(tmp_path / data), "--out", str(tmp_path / out), *extra])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and got


def test_plot_trajectory_matches_the_jax_tool(tmp_path):
    rng = np.random.default_rng(0)
    for d in ("gt", "pred"):
        os.makedirs(tmp_path / d)
    for seq in ("09", "10"):
        gt, pred = [np.eye(4)], [np.eye(4)]
        for _ in range(40):
            step = se3_exp(rng.normal(0, 0.02, 3), np.array([0.0, 0.0, 1.0]))
            gt.append(gt[-1] @ step)
            pred.append(pred[-1] @ se3_exp(rng.normal(0, 0.02, 3), rng.normal(0, 0.1, 3))
                        @ step)
        save_kitti_poses(str(tmp_path / "gt" / f"{seq}.txt"), np.asarray(gt))
        save_kitti_poses(str(tmp_path / "pred" / f"{seq}.txt"), 0.7 * np.asarray(pred))
    args = ["--gt_dir", str(tmp_path / "gt"), "--pred_dir", str(tmp_path / "pred")]
    got = plot_trajectory.main(args + ["--out", str(tmp_path / "port")])
    want = jax_plot_trajectory.main(args + ["--out", str(tmp_path / "jax")])
    assert sorted(got) == sorted(want) == ["09", "10"]
    for seq in want:
        assert sorted(got[seq]) == sorted(want[seq])
        for k, w in want[seq].items():
            assert abs(got[seq][k] - w) <= 1e-12 * max(1.0, abs(w))
        assert (tmp_path / "port" / f"{seq}_alignments.png").is_file()


def test_video_demo_writes_a_frame_per_pair(accepted, tmp_path):
    """Both branches (the demo draws both layouts); random weights."""
    import cv2

    wd, _ = accepted
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=H, occ_map_size=H // 4)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "both.pth")
    cfg = tmp_path / "cfg.py"
    model_cfg = dict(name="JPerceiver", height=H, width=H, occ_map_size=H // 4,
                     skip_inactive_branch=False)
    cfg.write_text(f"model = {model_cfg!r}\ndata = {{}}\n")
    out = str(tmp_path / "demo.avi")
    video_demo.main(["--config", str(cfg), "--checkpoint", str(tmp_path / "both.pth"),
                     "--images", str(wd / "seq" / "21" / "image_2"), "--out", out,
                     "--max_frames", "3", "--device", "cpu"])
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 2
