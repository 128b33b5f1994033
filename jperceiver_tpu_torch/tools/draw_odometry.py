"""Visual-odometry evaluation: the pose net over a sequence -> the KITTI
benchmark (counterpart of `jperceiver_tpu/tools/draw_odometry.py`).

The pose net runs on consecutive frame pairs (`JPerceiver.pose_between`),
the transforms are chained into a global trajectory (`global @= inv(T)`),
saved as KITTI pose rows, scored by the odometry protocol (scale-aligned
t_rel / r_rel) and plotted.

    python -m jperceiver_tpu_torch.tools.draw_odometry --config cfg.py \
        --checkpoint work_dir --sequence 09 --out out/

The ground truth is `<gt_dir>/<seq>.txt`; without `--gt_dir` it is the
packaged KITTI odometry poses of sequences 00-10 and 12
(`data/splits.py::default_gt_pose_dir`). `predict_and_score` is all of it
but the plot, which needs matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="a work dir with checkpoints/, or a checkpoint file")
    p.add_argument("--sequence", default="09")
    p.add_argument("--gt_dir", default=None,
                   help="dir with <seq>.txt ground-truth poses; default: the packaged "
                        "data/artifacts/gt_pose (KITTI 00-10, 12)")
    p.add_argument("--out", required=True)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    if args.gt_dir is None:
        from ..data.splits import default_gt_pose_dir

        args.gt_dir = default_gt_pose_dir()
        if args.gt_dir is None:
            p.error("--gt_dir is needed: the packaged data/artifacts/gt_pose is missing")
    return args


def predict_and_score(argv=None) -> dict:
    """Predict the sequence's poses into `<out>/<seq>.txt` and score them;
    returns `KittiOdomEval.eval_sequence`'s result with `poses` (N, 4, 4)."""
    args = parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..config import Config
    from ..data.kitti import pil_open_rgb
    from ..data.transforms import resize_image, to_array
    from ..engine.checkpoint import load_weights
    from ..evaluation.kitti_odometry import KittiOdomEval
    from ..evaluation.trajectory import save_kitti_poses
    from ..models import build_model

    cfg = Config.fromfile(args.config)
    dev = resolve_device(args.device)
    model = build_model(cfg.model)
    load_weights(args.checkpoint, model, epoch=args.epoch)
    model.to(dev).eval()
    h, w = cfg.model.height, cfg.model.width
    seq_dir = os.path.join(cfg.data.in_path, args.sequence, "image_2")
    frames = sorted(f for f in os.listdir(seq_dir) if f.endswith((".png", ".jpg")))

    def load(f):
        img = to_array(resize_image(pil_open_rgb(os.path.join(seq_dir, f)), h, w))
        return torch.from_numpy(img).permute(2, 0, 1)[None].to(dev)

    global_pose = np.eye(4)
    rows = [global_pose.copy()]
    prev = load(frames[0])
    with torch.inference_mode():
        for f in frames[1:]:
            cur = load(f)
            T = model.pose_between(prev, cur)[0].double().cpu().numpy()
            global_pose = global_pose @ np.linalg.inv(T)
            rows.append(global_pose.copy())
            prev = cur

    os.makedirs(args.out, exist_ok=True)
    pred_path = os.path.join(args.out, f"{args.sequence}.txt")
    save_kitti_poses(pred_path, np.asarray(rows))
    print(f"saved {len(rows)} poses -> {pred_path}")
    res = KittiOdomEval(args.gt_dir, args.out, align_scale=True).eval_sequence(args.sequence)
    print(f"seq {args.sequence}: t_rel {res['t_rel_percent']:.2f}% "
          f"r_rel {res['r_rel_deg_per_100m']:.3f} deg/100m ({res['n_segments']} segments)")
    return dict(res, poses=np.asarray(rows))


def main(argv=None) -> dict:
    res = predict_and_score(argv)
    args = parse_args(argv)

    from ..evaluation.kitti_odometry import KittiOdomEval

    KittiOdomEval(args.gt_dir, args.out, align_scale=True).plot_trajectory(
        args.sequence, os.path.join(args.out, f"{args.sequence}.png"))
    return res


if __name__ == "__main__":
    main()
