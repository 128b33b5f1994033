"""The port's packaged split lists and KITTI ground-truth poses
(`jperceiver_tpu_torch/data/artifacts/`) against the JAX package's.

- the port's archive unpacks to the JAX package's files, byte for byte
  (into the package on first use, and into any directory, where it keeps
  a directory already there), and nothing of the JAX package is read by
  the port (no string path into it);
- `default_split_dir()` / `default_gt_pose_dir()` lie in the port, and
  `pyproject.toml`'s package data covers every tracked file of it;
- every preset's split has its training and evaluation list there;
- on a fake KITTI odometry tree written for the first packaged
  `odometry/val_files.txt` lines (and the first train lines),
  `get_dataset` with `split_dir` None gives the JAX `get_dataset`'s
  samples, array for array (exact, velodyne depth to 1e-4 m as in
  `test_torch_data.py`);
- `tools/draw_odometry` without `--gt_dir` scores against the packaged
  poses: the JAX `KittiOdomEval`'s numbers on a perturbed `09.txt` to
  1e-12, and `predict_and_score` on a 6-frame sequence `04` on the CPU.

Every test runs on one intra-op thread.
"""

import ast
import filecmp
import fnmatch
import os
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jperceiver_tpu.data as jdata
import jperceiver_tpu_torch.data as pdata
from jperceiver_tpu.data import splits as jax_splits
from jperceiver_tpu.evaluation.kitti_odometry import KittiOdomEval as JaxKittiOdomEval
from jperceiver_tpu_torch.config import Config
from jperceiver_tpu_torch.data import splits as port_splits
from jperceiver_tpu_torch.evaluation.kitti_odometry import KittiOdomEval
from jperceiver_tpu_torch.evaluation.trajectory import load_kitti_poses, save_kitti_poses
from jperceiver_tpu_torch.evaluation.transforms import se3_exp
from jperceiver_tpu_torch.tools import draw_odometry
from jperceiver_tpu_torch.tools.acceptance import render_odometry_sequence
from test_torch_data import _assert_same, _seeded

ROOT = Path(__file__).resolve().parents[1]
PORT_ART = ROOT / "jperceiver_tpu_torch" / "data" / "artifacts"
JAX_ART = ROOT / "jperceiver_tpu" / "data" / "artifacts"
PRESETS = sorted((ROOT / "jperceiver_tpu_torch" / "config" / "presets").glob("*.py"))
# The raw drive date of odometry sequence 00 (`data/kitti.py::ODOM_TO_RAW`).
SEQ00_DATE = "2011_10_03"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_same_tree(root: Path, sub: str):
    port, jax = _files(root / sub), _files(JAX_ART / sub)
    assert port == jax and len(port) >= 12
    _, mismatch, errors = filecmp.cmpfiles(root / sub, JAX_ART / sub, port, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("sub", ["splits", "gt_pose"])
def test_packaged_files_equal_the_jax_packages(sub):
    default = {"splits": port_splits.default_split_dir,
               "gt_pose": port_splits.default_gt_pose_dir}[sub]
    assert Path(default()) == PORT_ART / sub
    _assert_same_tree(PORT_ART, sub)


def test_unpack_artifacts_is_whole_and_keeps_what_is_there(tmp_path):
    port_splits.unpack_artifacts(dest=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["gt_pose", "splits"]
    for sub in ("splits", "gt_pose"):
        _assert_same_tree(tmp_path, sub)
    edited = tmp_path / "splits" / "odometry" / "val_files.txt"
    edited.write_text("00/road_dense128/000001.png\n")
    port_splits.unpack_artifacts(dest=str(tmp_path))
    assert edited.read_text() == "00/road_dense128/000001.png\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["gt_pose", "splits"]


def test_default_dirs_lie_in_the_port():
    port = ROOT / "jperceiver_tpu_torch"
    split_dir, gt_dir = Path(port_splits.default_split_dir()), Path(
        port_splits.default_gt_pose_dir())
    assert split_dir == PORT_ART / "splits" and gt_dir == PORT_ART / "gt_pose"
    assert port in split_dir.parents and port in gt_dir.parents
    assert Path(port_splits.ARTIFACTS_DIR) == PORT_ART


def test_package_data_covers_the_archive():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["jperceiver_tpu_torch.data"]
    tracked = [p for p in PORT_ART.iterdir() if p.is_file()]
    assert sorted(p.name for p in tracked) == ["README.md", "artifacts.tar.xz"]
    for p in tracked:
        path = str(p.relative_to(ROOT / "jperceiver_tpu_torch" / "data"))
        # setuptools' globs: `*` stays within one directory level.
        assert any(fnmatch.fnmatch(path, g) and path.count("/") == g.count("/")
                   for g in globs), path


def test_no_port_module_names_a_jax_package_path():
    """No string in a port module's code (docstrings aside) is a path into
    the JAX package: the port reads its own copy."""
    hits = []
    for path in sorted((ROOT / "jperceiver_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        hits += [(str(path), n.lineno) for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and id(n) not in docs
                 and ("jperceiver_tpu/" in n.value or n.value == "jperceiver_tpu")]
    assert not hits


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.stem)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_every_preset_split_has_its_packaged_list(preset, training):
    cfg = Config.fromfile(str(preset))
    assert cfg.data.get("split_dir") is None
    path = port_splits.split_file(port_splits.default_split_dir(), cfg.data.split, training)
    assert os.path.isfile(path) and port_splits.readlines(path)
    want = jax_splits.split_file(jax_splits.default_split_dir(), cfg.data.split, training)
    assert port_splits.readlines(path) == jax_splits.readlines(want)


def _packaged_lines(name: str, n: int) -> list[str]:
    return port_splits.readlines(os.path.join(port_splits.default_split_dir(), "odometry",
                                              name))[:n]


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """A KITTI odometry tree for the first 3 packaged val lines (sequence
    00) and the first 2 train lines (sequence 02): each line's frame and its
    -1/+1 neighbours (small images, 8-bit noise), road labels, calib.txt a
    sequence, velodyne scans for the val frames and sequence 00's raw-calib
    date directory."""
    root = tmp_path_factory.mktemp("kitti_packaged")
    seqs, raw = root / "sequences", root / "raw"
    rng = np.random.default_rng(0)
    lines = _packaged_lines("val_files.txt", 3) + _packaged_lines("train_files.txt", 2)
    for line in lines:
        seq, frame = line.split("/")[0], int(Path(line).stem)
        d = seqs / seq
        for sub in ("image_2", "road_dense128", "velodyne"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        for f in (frame - 1, frame, frame + 1):
            Image.fromarray(rng.integers(0, 256, (38, 124, 3), dtype=np.uint8)).save(
                d / "image_2" / f"{f:06d}.png")
            lbl = np.zeros((128, 128), np.uint8)
            lbl[rng.integers(20, 60):, rng.integers(10, 50):rng.integers(70, 120)] = 255
            Image.fromarray(lbl).save(d / "road_dense128" / f"{f:06d}.png")
        pts = np.zeros((3000, 4), np.float32)
        pts[:, 0] = rng.uniform(2, 60, 3000)
        pts[:, 1] = rng.uniform(-15, 15, 3000)
        pts[:, 2] = rng.uniform(-2, 1, 3000)
        pts.tofile(d / "velodyne" / f"{frame:06d}.bin")
        (d / "calib.txt").write_text(
            "P0: 718.9 0 607.2 0 0 718.9 185.2 0 0 0 1 0\n"
            "P1: 718.9 0 607.2 -386.1 0 718.9 185.2 0 0 0 1 0\n"
            "P2: 718.9 0 607.2 45.4 0 718.9 185.2 -0.1 0 0 1 0.003\n"
            "P3: 718.9 0 607.2 -337.3 0 718.9 185.2 2.4 0 0 1 0.005\n"
            "Tr: 0.000428 -0.999967 -0.008084 -0.011985 -0.007211 0.008081 -0.999941 "
            "-0.054040 0.999974 0.000486 -0.007207 -0.292197\n")
    (raw / SEQ00_DATE).mkdir(parents=True)
    (raw / SEQ00_DATE / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
        "P_rect_02: 718.9 0 607.2 45.4 0 718.9 185.2 -0.1 0 0 1 0.003\n"
        "S_rect_02: 1241 376\n")
    (raw / SEQ00_DATE / "calib_velo_to_cam.txt").write_text("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 0 0\n")
    return str(seqs), str(raw)


@pytest.mark.parametrize("training", [False, True], ids=["val", "train"])
def test_get_dataset_with_the_packaged_lists_matches_jax(kitti_tree, monkeypatch, training):
    seqs, raw = kitti_tree
    cfg = dict(name="kitti_odom", type="static", split="odometry", split_dir=None,
               in_path=seqs, raw_calib_root=raw, height=64, width=64)
    want = jdata.get_dataset(dict(cfg), training=training, with_sdf=True)
    got = pdata.get_dataset(dict(cfg), training=training, with_sdf=True)
    assert isinstance(got, pdata.KittiOdometry) and got.filenames == want.filenames
    assert len(got) == (15806 if training else 6636)
    n = 2 if training else 3
    assert got.filenames[:n] == _packaged_lines(
        "train_files.txt" if training else "val_files.txt", n)
    for i in range(n):
        if training:
            for seed in (1, 2):
                _assert_same(_seeded(monkeypatch, seed, lambda: got[i]),
                             _seeded(monkeypatch, seed, lambda: want[i]), f"train[{i}] {seed}")
        else:
            sample = got[i]
            assert sample["gt_depth"].shape == (375, 1242) and (sample["gt_depth"] > 0).any()
            _assert_same(sample, want[i], f"val[{i}]")


def test_draw_odometry_defaults_to_the_packaged_poses():
    args = draw_odometry.parse_args(["--config", "c.py", "--checkpoint", "w", "--out", "o"])
    assert args.gt_dir == port_splits.default_gt_pose_dir()
    assert os.path.isfile(os.path.join(args.gt_dir, "04.txt"))
    args = draw_odometry.parse_args(["--config", "c.py", "--checkpoint", "w", "--out", "o",
                                     "--gt_dir", "elsewhere"])
    assert args.gt_dir == "elsewhere"


def test_packaged_poses_score_as_jax(tmp_path):
    """A perturbed sequence 09 (1,591 poses: each step's motion moved by a
    small twist) scored against each package's own packaged ground truth."""
    gt = load_kitti_poses(os.path.join(port_splits.default_gt_pose_dir(), "09.txt"))
    rng = np.random.default_rng(9)
    rows = [gt[0]]
    for a, b in zip(gt[:-1], gt[1:]):
        step = np.linalg.inv(a) @ b @ se3_exp(rng.normal(0, [2e-3, 4e-3, 2e-3]),
                                              rng.normal(0, [0.02, 0.02, 0.05]))
        rows.append(rows[-1] @ step)
    save_kitti_poses(str(tmp_path / "09.txt"), np.asarray(rows))
    got = KittiOdomEval(port_splits.default_gt_pose_dir(), str(tmp_path)).eval_sequence("09")
    want = JaxKittiOdomEval(jax_splits.default_gt_pose_dir(), str(tmp_path)).eval_sequence("09")
    assert got["n_frames"] == want["n_frames"] == 1591
    assert got["n_segments"] == want["n_segments"] > 0
    for k in ("t_rel_percent", "r_rel_deg_per_100m"):
        assert got[k] > 0 and abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k


def test_predict_and_score_against_the_packaged_04(tmp_path):
    from jperceiver_tpu_torch.models import build_model

    h = 128
    seq_root = tmp_path / "seq"
    render_odometry_sequence(str(seq_root), "04", str(tmp_path / "unused_gt"), h, 6)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"model = {dict(name='JPerceiver', height=h, width=h, occ_map_size=h // 4)!r}\n"
                   f"data = {dict(in_path=str(seq_root))!r}\n")
    torch.manual_seed(0)
    model = build_model(Config.fromfile(str(cfg)).model)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "weights.pth")
    res = draw_odometry.predict_and_score(
        ["--config", str(cfg), "--checkpoint", str(tmp_path / "weights.pth"),
         "--sequence", "04", "--out", str(tmp_path / "odom"), "--device", "cpu"])
    packaged = load_kitti_poses(os.path.join(port_splits.default_gt_pose_dir(), "04.txt"))
    assert len(packaged) == 271 and res["n_frames"] == 6 and len(res["poses"]) == 6
    np.testing.assert_array_equal(res["_gt"], packaged[:6])
    # Six frames of sequence 04 span a few metres: no 100 m segment yet.
    assert res["n_segments"] == 0 and res["distance_m"] > 0
