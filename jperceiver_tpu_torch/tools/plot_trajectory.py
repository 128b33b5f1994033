"""Trajectory plotting with Umeyama alignment variants (counterpart of
`jperceiver_tpu/tools/plot_trajectory.py`).

Parity with `scripts/plot_kitti.py:15-301`: overlay GT and predicted KITTI
trajectories under scale-only / 6-DoF / 7-DoF alignment, report ATE for
each, save a figure per sequence.

  python -m jperceiver_tpu_torch.tools.plot_trajectory --gt_dir gt_pose/ \
      --pred_dir results/ --sequences 09 10 --out plots/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--sequences", nargs="+", default=["09", "10"])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..evaluation.trajectory import (
        align_trajectory,
        load_kitti_poses,
        positions,
    )

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for seq in args.sequences:
        gt = load_kitti_poses(os.path.join(args.gt_dir, f"{seq}.txt"))
        pred = load_kitti_poses(os.path.join(args.pred_dir, f"{seq}.txt"))
        n = min(len(gt), len(pred))
        gt, pred = gt[:n], pred[:n]

        variants = {
            "scale": align_trajectory(pred, gt, correct_only_scale=True),
            "6dof": align_trajectory(pred, gt, correct_scale=False),
            "7dof": align_trajectory(pred, gt, correct_scale=True),
        }
        fig, ax = plt.subplots(figsize=(7, 7))
        g = positions(gt)
        ax.plot(g[:, 0], g[:, 2], "k-", lw=2, label="GT")
        colors = {"scale": "tab:blue", "6dof": "tab:orange", "7dof": "tab:green"}
        seq_res = {}
        for name, traj in variants.items():
            q = positions(traj)
            ate = float(np.sqrt(((q - g) ** 2).sum(1).mean()))
            seq_res[name] = ate
            ax.plot(q[:, 0], q[:, 2], color=colors[name], lw=1,
                    label=f"{name} (ATE {ate:.2f} m)")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.axis("equal")
        ax.legend()
        ax.set_title(f"KITTI {seq}")
        path = os.path.join(args.out, f"{seq}_alignments.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        results[seq] = seq_res
        print(f"seq {seq}: " + "  ".join(
            f"{k}: ATE {v:.3f} m" for k, v in seq_res.items()))
    return results


if __name__ == "__main__":
    main()
