"""KITTI odometry benchmark evaluation (t_rel %, r_rel deg/m).

The port's own copy of `jperceiver_tpu/evaluation/kitti_odometry.py` (numpy only; the port imports
nothing of the JAX package).

Re-implementation of the official devkit protocol used by the reference's
`mono/tools/kitti_evaluation_toolkit.py:147-201,554-640`:

* per-frame cumulative path length,
* for every frame and every segment length in {100..800} m, the relative
  pose error  E = inv(gt_i^-1 gt_j) (pred_i^-1 pred_j),
* translation error = |t(E)| / len, rotation error = angle(E) / len,
* averaged over all valid segments; optional Umeyama scale pre-alignment
  (the reference aligns with `correct_only_scale=True`, `:569-574`).
"""

from __future__ import annotations

import os

import numpy as np

from .trajectory import align_trajectory, load_kitti_poses

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length per frame."""
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def _last_frame_from_len(dist: np.ndarray, first: int, seg_len: float) -> int:
    target = dist[first] + seg_len
    # side='right': first frame with dist STRICTLY greater than target —
    # `lastFrameFromSegmentLength` uses `>` (`kitti_evaluation_toolkit.py:141-146`).
    idx = np.searchsorted(dist, target, side="right")
    return int(idx) if idx < len(dist) else -1


def rotation_error(E: np.ndarray) -> float:
    a = 0.5 * (np.trace(E[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(a, -1.0, 1.0)))


def translation_error(E: np.ndarray) -> float:
    return float(np.linalg.norm(E[:3, 3]))


def sequence_errors(gt: np.ndarray, pred: np.ndarray, step: int = 10):
    """[(first, r_err/len, t_err/len, seg_len, speed), ...] over segments.

    Parity with `calcSequenceErrors` (`kitti_evaluation_toolkit.py:147-182`)
    incl. the per-segment speed (10 Hz KITTI frame rate, `:178-180`).
    """
    dist = trajectory_distances(gt)
    errors = []
    for first in range(0, len(gt), step):
        for seg_len in SEGMENT_LENGTHS:
            last = _last_frame_from_len(dist, first, seg_len)
            if last < 0 or last >= len(pred):
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            pr_rel = np.linalg.inv(pred[first]) @ pred[last]
            E = np.linalg.inv(gt_rel) @ pr_rel
            speed = seg_len / (0.1 * (last - first + 1.0))
            errors.append(
                (first, rotation_error(E) / seg_len,
                 translation_error(E) / seg_len, seg_len, speed)
            )
    return errors


def average_errors(errors) -> tuple[float, float]:
    """(t_rel %, r_rel deg/100m) — the two headline numbers."""
    if not errors:
        return float("nan"), float("nan")
    r = np.mean([e[1] for e in errors])
    t = np.mean([e[2] for e in errors])
    return float(t * 100.0), float(np.degrees(r) * 100.0)


def segment_error_curve(errors) -> dict[int, list[float]]:
    """{segment_length: [avg_t_err, avg_r_err]} (`computeSegmentErr`,
    `kitti_evaluation_toolkit.py:488-511`); [] for empty buckets."""
    out: dict[int, list[float]] = {}
    for seg_len in SEGMENT_LENGTHS:
        bucket = [(e[2], e[1]) for e in errors if e[3] == seg_len]
        out[seg_len] = (
            [float(np.mean([b[0] for b in bucket])),
             float(np.mean([b[1] for b in bucket]))] if bucket else []
        )
    return out


def speed_error_curve(errors) -> dict[int, list[float]]:
    """{speed m/s: [avg_t_err, avg_r_err]} over 2..24 m/s buckets
    (`computeSpeedErr`, `kitti_evaluation_toolkit.py:514-540`)."""
    out: dict[int, list[float]] = {}
    for s in range(2, 25, 2):
        bucket = [(e[2], e[1]) for e in errors if abs(e[4] - s) < 2.0]
        out[s] = (
            [float(np.mean([b[0] for b in bucket])),
             float(np.mean([b[1] for b in bucket]))] if bucket else []
        )
    return out


def save_sequence_errors(errors, path: str) -> None:
    """One `first r/len t/len len speed` line per segment
    (`saveSequenceErrors`, `kitti_evaluation_toolkit.py:184-189`)."""
    with open(path, "w") as f:
        for e in errors:
            f.write(" ".join(str(v) for v in e) + "\n")


# Lidar -> camera coordinate change for externally-produced pose files
# (`toCameraCoord`, `kitti_evaluation_toolkit.py:56-67`).
_R_C2L = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)


def to_camera_coord(pose: np.ndarray) -> np.ndarray:
    return np.linalg.inv(_R_C2L) @ pose @ _R_C2L


class KittiOdomEval:
    """Evaluate predicted KITTI pose files against ground truth.

    Parity with `kittiOdomEval.eval` (`kitti_evaluation_toolkit.py:554-640`):
    scale-only Umeyama alignment, per-segment errors, optional plots.
    """

    def __init__(self, gt_dir: str, result_dir: str, align_scale: bool = True):
        self.gt_dir = gt_dir
        self.result_dir = result_dir
        self.align_scale = align_scale

    def eval_sequence(self, seq: str) -> dict:
        gt = load_kitti_poses(os.path.join(self.gt_dir, f"{seq}.txt"))
        pred = load_kitti_poses(os.path.join(self.result_dir, f"{seq}.txt"))
        n = min(len(gt), len(pred))
        gt, pred = gt[:n], pred[:n]
        if self.align_scale:
            pred = align_trajectory(pred, gt, correct_only_scale=True)
        errs = sequence_errors(gt, pred)
        t_rel, r_rel = average_errors(errs)
        dist = trajectory_distances(gt)
        return {"seq": seq, "t_rel_percent": t_rel, "r_rel_deg_per_100m": r_rel,
                "n_frames": n, "n_segments": len(errs),
                "distance_m": float(dist[-1]) if n else 0.0,
                "max_speed_ms": float(max((e[4] for e in errs), default=0.0)),
                "segment_errors": segment_error_curve(errs),
                "speed_errors": speed_error_curve(errs),
                "_raw_errors": errs, "_gt": gt, "_pred": pred}

    def eval(self, seqs, plot: bool = True) -> dict:
        """Full offline evaluation: per-sequence stats files, error dumps and
        the plot suite — the workflow of `kittiOdomEval.eval`
        (`kitti_evaluation_toolkit.py:554-640`)."""
        results = {}
        for seq in seqs:
            out_dir = os.path.join(self.result_dir, f"{seq}_eval")
            os.makedirs(out_dir, exist_ok=True)
            r = self.eval_sequence(seq)
            save_sequence_errors(
                r["_raw_errors"], os.path.join(out_dir, f"{seq}_error.txt"))
            with open(os.path.join(out_dir, f"{seq}_stats.txt"), "w") as f:
                f.write("Average sequence translation RMSE (%):    "
                        f"{r['t_rel_percent']:.4f}\n")
                f.write("Average sequence rotation error (deg/m):  "
                        f"{r['r_rel_deg_per_100m'] / 100.0:.6f}")
            if plot:
                gt, pred = r["_gt"], r["_pred"]
                self.plot_path_2d(seq, gt, pred, os.path.join(out_dir, f"{seq}_path2d.png"))
                self.plot_path_3d(seq, gt, pred, os.path.join(out_dir, f"{seq}_path3d.png"))
                self.plot_xyz(seq, gt, pred, os.path.join(out_dir, f"{seq}_xyz.png"))
                self.plot_rpy(seq, gt, pred, os.path.join(out_dir, f"{seq}_rpy.png"))
                self.plot_error_segment(
                    seq, r["segment_errors"], os.path.join(out_dir, f"{seq}_err_seg.png"))
                self.plot_error_speed(
                    seq, r["speed_errors"], os.path.join(out_dir, f"{seq}_err_speed.png"))
            results[seq] = {k: v for k, v in r.items() if not k.startswith("_")}
        return results

    # -- plot suite (`kitti_evaluation_toolkit.py:203-487`) -----------------

    @staticmethod
    def _plt():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def plot_xyz(self, seq, gt, pred, out_path) -> None:
        plt = self._plt()
        fig, axarr = plt.subplots(3, sharex="col", figsize=(6, 6))
        for poses, style, label in ((gt, "-", "GT"), (pred, "--", "Ours")):
            if poses is None:
                continue
            xyz = poses[:, :3, 3]
            for i, ylab in enumerate(("$x$ (m)", "$y$ (m)", "$z$ (m)")):
                axarr[i].plot(range(len(xyz)), xyz[:, i], style, label=label)
                axarr[i].set_ylabel(ylab)
        axarr[2].set_xlabel("index")
        axarr[0].legend(frameon=True)
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)

    def plot_rpy(self, seq, gt, pred, out_path, axes: str = "szxy") -> None:
        from .transforms import euler_from_matrix_axes

        plt = self._plt()
        fig, axarr = plt.subplots(3, sharex="col", figsize=(6, 6))
        for poses, style, label in ((gt, "-", "GT"), (pred, "--", "Ours")):
            if poses is None:
                continue
            rpy = np.degrees([euler_from_matrix_axes(p, axes) for p in poses])
            for i, ylab in enumerate(("$roll$ (deg)", "$pitch$ (deg)", "$yaw$ (deg)")):
                axarr[i].plot(range(len(rpy)), rpy[:, i], style, label=label)
                axarr[i].set_ylabel(ylab)
        axarr[2].set_xlabel("index")
        axarr[0].legend(frameon=True)
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)

    def plot_path_2d(self, seq, gt, pred, out_path) -> None:
        plt = self._plt()
        fig, ax = plt.subplots(figsize=(6, 6))
        if gt is not None:
            ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k-", label="GT")
        ax.plot(pred[:, 0, 3], pred[:, 2, 3], "b-", label="Ours")
        ax.plot(pred[0, 0, 3], pred[0, 2, 3], "ko", label="Start")
        ax.set_xlabel("x (m)")
        ax.set_ylabel("z (m)")
        ax.legend()
        ax.set_title(f"KITTI {seq}")
        ax.axis("equal")
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
        plt.close(fig)

    def plot_path_3d(self, seq, gt, pred, out_path) -> None:
        plt = self._plt()
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
        if gt is not None:
            ax.plot(gt[:, 0, 3], gt[:, 2, 3], gt[:, 1, 3], "k-", label="GT")
        ax.plot(pred[:, 0, 3], pred[:, 2, 3], pred[:, 1, 3], "b-", label="Ours")
        ax.set_xlabel("x (m)")
        ax.set_ylabel("z (m)")
        ax.set_zlabel("y (m)")
        ax.legend()
        ax.set_title(f"KITTI {seq}")
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
        plt.close(fig)

    def plot_error_segment(self, seq, segment_errs, out_path) -> None:
        plt = self._plt()
        fig, (a_t, a_r) = plt.subplots(1, 2, figsize=(10, 4))
        lens = [l for l in SEGMENT_LENGTHS if segment_errs.get(l)]
        a_t.plot(lens, [segment_errs[l][0] * 100 for l in lens], "bs-")
        a_t.set_xlabel("Path Length (m)")
        a_t.set_ylabel("Translation Error (%)")
        a_r.plot(lens, [np.degrees(segment_errs[l][1]) * 100 for l in lens], "bs-")
        a_r.set_xlabel("Path Length (m)")
        a_r.set_ylabel("Rotation Error (deg/100m)")
        fig.suptitle(f"KITTI {seq}")
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)

    def plot_error_speed(self, seq, speed_errs, out_path) -> None:
        plt = self._plt()
        fig, (a_t, a_r) = plt.subplots(1, 2, figsize=(10, 4))
        speeds = [s for s in sorted(speed_errs) if speed_errs[s]]
        kmh = [s * 3.6 for s in speeds]
        a_t.plot(kmh, [speed_errs[s][0] * 100 for s in speeds], "bs-")
        a_t.set_xlabel("Speed (km/h)")
        a_t.set_ylabel("Translation Error (%)")
        a_r.plot(kmh, [np.degrees(speed_errs[s][1]) * 100 for s in speeds], "bs-")
        a_r.set_xlabel("Speed (km/h)")
        a_r.set_ylabel("Rotation Error (deg/100m)")
        fig.suptitle(f"KITTI {seq}")
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)

    def plot_trajectory(self, seq: str, out_path: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        gt = load_kitti_poses(os.path.join(self.gt_dir, f"{seq}.txt"))
        pred = load_kitti_poses(os.path.join(self.result_dir, f"{seq}.txt"))
        if self.align_scale:
            pred = align_trajectory(pred[: len(gt)], gt[: len(pred)],
                                    correct_only_scale=True)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k-", label="GT")
        ax.plot(pred[:, 0, 3], pred[:, 2, 3], "b-", label="Ours")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.legend()
        ax.set_title(f"KITTI {seq}")
        ax.axis("equal")
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
