"""The port's `evaluation/` (metrics, rotation conversions, pose files and
trajectory alignment, the KITTI odometry protocol), `data/utils.py` and the
split scanners against the JAX package's, on inputs made with numpy from a
seed: every number within 1e-12 relative (both are numpy; the copies run the
same operations), files and split lists equal.
"""

import os

import numpy as np
import pytest

import jperceiver_tpu.data.splits as jax_splits
import jperceiver_tpu.data.utils as jax_utils
import jperceiver_tpu.evaluation.kitti_odometry as jax_odom
import jperceiver_tpu.evaluation.metrics as jax_metrics
import jperceiver_tpu.evaluation.trajectory as jax_traj
import jperceiver_tpu.evaluation.transforms as jax_tf
import jperceiver_tpu_torch.data.splits as splits
import jperceiver_tpu_torch.data.utils as utils
import jperceiver_tpu_torch.evaluation.kitti_odometry as odom
import jperceiver_tpu_torch.evaluation.metrics as metrics
import jperceiver_tpu_torch.evaluation.trajectory as traj
import jperceiver_tpu_torch.evaluation.transforms as tf

REL = 1e-12


def assert_same(got, want, what=""):
    """Numbers within REL relative (NaN where NaN), containers by element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, str):
        assert got == want, what
    else:
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        assert np.array_equal(np.isnan(g), np.isnan(w)), what
        ok = ~np.isnan(w)
        err = np.abs(g[ok] - w[ok])
        assert (err <= REL * np.maximum(1.0, np.abs(w[ok]))).all(), (what, err.max())


def trajectory(n=130, seed=0, scale=1.0):
    """A drive of n frames, ~1 m a frame, turning and pitching a little."""
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        T = tf.se3_exp(rng.normal(0, 0.01, 3), np.array([0.0, 0.0, scale]) + rng.normal(0, 0.05, 3))
        poses.append(poses[-1] @ T)
    return np.asarray(poses)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_metrics_match(rng):
    gt = rng.uniform(1e-3, 80, 500)
    pred = gt * rng.uniform(0.7, 1.3, 500)
    assert_same(metrics.compute_depth_errors(gt, pred), jax_metrics.compute_depth_errors(gt, pred))
    for n_cls in (2, 3):
        p, g = rng.integers(0, n_cls, (32, 32)), rng.integers(0, n_cls, (32, 32))
        assert_same(metrics.confusion_counts(p, g, n_cls), jax_metrics.confusion_counts(p, g, n_cls))
        assert_same(metrics.mean_iu(p, g), jax_metrics.mean_iu(p, g))
        assert_same(metrics.mean_precision(p, g), jax_metrics.mean_precision(p, g))
    one = np.zeros((8, 8), np.int64)  # a single-class label
    assert_same(metrics.mean_iu(one, one), jax_metrics.mean_iu(one, one))
    m, jm = metrics.AverageMeter(), jax_metrics.AverageMeter()
    for v, n in zip(rng.uniform(0, 1, 7), rng.integers(1, 4, 7)):
        m.update(float(v), int(n))
        jm.update(float(v), int(n))
    assert_same([m.val, m.sum, m.count, m.avg], [jm.val, jm.sum, jm.count, jm.avg])


def test_transforms_match(rng):
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        M = tf.quaternion_matrix(q)
        assert_same(M, jax_tf.quaternion_matrix(q))
        assert_same(tf.quaternion_from_matrix(M), jax_tf.quaternion_from_matrix(M))
        assert_same(tf.euler_from_matrix(M), jax_tf.euler_from_matrix(M))
        for axes in ("sxyz", "szxy", "rzyx", "sxyx"):
            assert_same(tf.euler_from_matrix_axes(M, axes), jax_tf.euler_from_matrix_axes(M, axes))
            a = rng.uniform(-np.pi, np.pi, 3)
            assert_same(tf.euler_matrix_axes(*a, axes), jax_tf.euler_matrix_axes(*a, axes))
        r = rng.uniform(-1, 1, 3)
        assert_same(tf.euler_matrix(*r), jax_tf.euler_matrix(*r))
        assert_same(tf.so3_log(M[:3, :3]), jax_tf.so3_log(M[:3, :3]))
        w, v = rng.normal(0, 0.5, 3), rng.normal(0, 2, 3)
        assert_same(tf.se3_exp(w, v), jax_tf.se3_exp(w, v))


def test_trajectory_io_and_alignment_match(tmp_path, rng):
    gt = trajectory(60, seed=1)
    pred = trajectory(60, seed=2, scale=0.6)
    for mod, d in ((traj, "port"), (jax_traj, "jax")):
        os.makedirs(tmp_path / d)
        mod.save_kitti_poses(str(tmp_path / d / "k.txt"), pred)
        mod.save_tum_trajectory(str(tmp_path / d / "t.txt"), pred,
                                np.arange(len(pred), dtype=np.float64) * 0.1)
    for name in ("k.txt", "t.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    k = str(tmp_path / "jax" / "k.txt")
    assert_same(traj.load_kitti_poses(k), jax_traj.load_kitti_poses(k))
    indexed = tmp_path / "indexed.txt"
    indexed.write_text("".join(f"{3 * i} " + " ".join(repr(float(v)) for v in p[:3].ravel()) + "\n"
                               for i, p in enumerate(pred[:5])))
    assert_same({str(k): v for k, v in traj.load_kitti_poses_indexed(str(indexed)).items()},
                {str(k): v for k, v in jax_traj.load_kitti_poses_indexed(str(indexed)).items()})
    t = str(tmp_path / "jax" / "t.txt")
    assert_same(traj.load_tum_trajectory(t), jax_traj.load_tum_trajectory(t))
    csv = tmp_path / "euroc.csv"
    rows = np.concatenate([np.arange(5)[:, None] * 1e8, rng.normal(size=(5, 3)),
                           rng.normal(size=(5, 4)), rng.normal(size=(5, 9))], 1)
    csv.write_text("#timestamp,p,q,rest\n" + "".join(",".join(repr(float(v)) for v in r) + "\n" for r in rows))
    assert_same(traj.load_euroc_csv(str(csv)), jax_traj.load_euroc_csv(str(csv)))
    rel = np.stack([np.linalg.inv(a) @ b for a, b in zip(pred[:-1], pred[1:])])
    assert_same(traj.accumulate_relative(rel), jax_traj.accumulate_relative(rel))
    assert_same(traj.positions(pred), jax_traj.positions(pred))
    x, y = traj.positions(pred).T, traj.positions(gt).T
    for with_scale in (True, False):
        assert_same(traj.umeyama_alignment(x, y, with_scale),
                    jax_traj.umeyama_alignment(x, y, with_scale))
    for kw in ({}, {"correct_scale": False}, {"correct_only_scale": True}):
        assert_same(traj.align_trajectory(pred, gt, **kw), jax_traj.align_trajectory(pred, gt, **kw))
    assert_same(traj.ate_rmse(pred, gt), jax_traj.ate_rmse(pred, gt))


def test_odometry_protocol_matches(tmp_path):
    gt = trajectory(230, seed=3)
    pred = trajectory(230, seed=4, scale=0.8)
    assert_same(odom.trajectory_distances(gt), jax_odom.trajectory_distances(gt))
    errs, jerrs = odom.sequence_errors(gt, pred), jax_odom.sequence_errors(gt, pred)
    assert len(jerrs) > 10
    assert_same(errs, jerrs)
    assert_same(odom.average_errors(errs), jax_odom.average_errors(jerrs))
    assert_same(odom.average_errors([]), jax_odom.average_errors([]))
    assert_same({str(k): v for k, v in odom.segment_error_curve(errs).items()},
                {str(k): v for k, v in jax_odom.segment_error_curve(jerrs).items()})
    assert_same({str(k): v for k, v in odom.speed_error_curve(errs).items()},
                {str(k): v for k, v in jax_odom.speed_error_curve(jerrs).items()})
    assert_same(odom.to_camera_coord(pred[7]), jax_odom.to_camera_coord(pred[7]))
    for d, mod in (("port", odom), ("jax", jax_odom)):
        os.makedirs(tmp_path / d / "gt")
        traj.save_kitti_poses(str(tmp_path / d / "gt" / "05.txt"), gt)
        traj.save_kitti_poses(str(tmp_path / d / "05.txt"), pred)
        mod.save_sequence_errors(errs, str(tmp_path / d / "errors.txt"))
    assert (tmp_path / "port" / "errors.txt").read_bytes() == \
        (tmp_path / "jax" / "errors.txt").read_bytes()
    got = odom.KittiOdomEval(str(tmp_path / "port" / "gt"), str(tmp_path / "port")).eval(
        ["05"], plot=False)
    want = jax_odom.KittiOdomEval(str(tmp_path / "jax" / "gt"), str(tmp_path / "jax")).eval(
        ["05"], plot=False)
    strkeys = lambda r: {k: ({str(a): b for a, b in v.items()} if isinstance(v, dict) else v)  # noqa: E731
                         for k, v in r["05"].items()}
    assert_same(strkeys(got), strkeys(want))
    for name in ("05_stats.txt", "05_error.txt"):
        assert (tmp_path / "port" / "05_eval" / name).read_bytes() == \
            (tmp_path / "jax" / "05_eval" / name).read_bytes()


def test_data_utils_match(rng):
    x = rng.normal(size=(5, 7))
    assert_same(utils.normalize_image(x), jax_utils.normalize_image(x))
    assert_same(utils.normalize_image(np.ones(3)), jax_utils.normalize_image(np.ones(3)))
    for t in (0.0, 59.9, 3725.5, 200000.0):
        assert utils.sec_to_hm(t) == jax_utils.sec_to_hm(t)
        assert utils.sec_to_hm_str(t) == jax_utils.sec_to_hm_str(t)
    poses = trajectory(20, seed=5)
    rel = [np.linalg.inv(a) @ b for a, b in zip(poses[:-1], poses[1:])]
    xyz = utils.dump_xyz(rel)
    assert_same(xyz, jax_utils.dump_xyz(rel))
    pred = xyz * 0.7 + rng.normal(0, 0.01, xyz.shape)
    assert_same(utils.compute_ate(xyz, pred), jax_utils.compute_ate(xyz, pred))
    ld, rd = rng.uniform(0, 1, (2, 6, 40)), rng.uniform(0, 1, (2, 6, 40))
    assert_same(utils.batch_post_process_disparity(ld, rd),
                jax_utils.batch_post_process_disparity(ld, rd))


def test_split_scanners_match(tmp_path):
    """Fake KITTI odometry and object trees, with a sequence that has no
    labels and files of other kinds beside the labels."""
    odo = tmp_path / "sequences"
    for seq, n in (("00", 3), ("04", 0), ("09", 2)):
        d = odo / seq / "road_dense128"
        if n:
            os.makedirs(d)
            for i in (2, 0, 1)[:n] if n == 3 else range(n):
                (d / f"{i:06d}.png").write_bytes(b"")
            (d / "notes.txt").write_text("x")
    seqs = ["00", "04", "09", "11"]
    got = splits.scan_odometry_split(str(odo), seqs)
    assert got == jax_splits.scan_odometry_split(str(odo), seqs) and len(got) == 5
    obj = tmp_path / "object"
    os.makedirs(obj / "training" / "vehicle_256")
    for f in ("000007.png", "000003.png", "000010.png", "readme.md"):
        (obj / "training" / "vehicle_256" / f).write_bytes(b"")
    got = splits.scan_object_split(str(obj))
    assert got == jax_splits.scan_object_split(str(obj)) == ["000003", "000007", "000010"]
    assert splits.scan_object_split(str(tmp_path)) == jax_splits.scan_object_split(str(tmp_path))
