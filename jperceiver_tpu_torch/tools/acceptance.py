"""End-to-end acceptance: train -> checkpoint -> eval -> odometry
(counterpart of `jperceiver_tpu/tools/acceptance.py`, the same config
template, sequence and `acceptance.json` keys).

One command proving the whole path on simulated scenes with analytic
ground truth (`data/simulated.py`), no external data needed:

  1. writes a config file and trains through `tools/train.py`
     (DataLoader over `SimulatedDataset`, Trainer, EvalHook validation,
     checkpoints),
  2. loads the newest checkpoint and runs `EvalHook` again for the depth
     (abs_rel against the analytic depth) and layout (road IoU) metrics,
  3. renders a >= 100 m forward drive in the KITTI odometry layout with its
     ground-truth poses and runs `tools/draw_odometry.py` on the checkpoint
     (pose chaining -> `KittiOdomEval` segment errors and plot).

Results land in work_dir/acceptance.json.

  python -m jperceiver_tpu_torch.tools.acceptance --work_dir out/acc
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CFG_TEMPLATE = """# auto-generated acceptance config (simulated scenes)
HEIGHT = {height}
WIDTH = {height}
FRAME_IDS = [0, -1, 1]

data = dict(
    name="simulated",
    type={mtype!r},
    split={split!r},
    height=HEIGHT,
    width=WIDTH,
    frame_ids=FRAME_IDS,
    n_scenes={n_scenes},
    in_path={seq_root!r},   # rendered odometry sequence (draw_odometry)
)

model = dict(
    name="JPerceiver",
    depth_num_layers=18,
    pose_num_layers=18,
    frame_ids=FRAME_IDS,
    imgs_per_gpu={imgs_per_gpu},
    height=HEIGHT,
    width=WIDTH,
    scales=[0, 1, 2, 3],
    min_depth=0.1,
    max_depth=100.0,
    automask=True,
    disp_norm=True,
    smoothness_weight=1e-3,
    scale_weight=0.1,
    static_weight=5.0,
    dynamic_weight=15.0,
    occ_map_size=HEIGHT // 4,
    num_class=2,
    type={mtype!r},
    split={split!r},
    loss_type="iou",
    loss_sum=3,
    loss_weight=20,
    loss2_weight=20,
    loss_weightS=20,
    loss2_weightS=20,
    cgt_label_hw={cgt_hw},
    compute_dtype="bfloat16",
)

imgs_per_gpu = {imgs_per_gpu}
workers_per_gpu = 2
total_epochs = {epochs}
validate = True
optimizer = dict(type="Adam", lr=1e-4, weight_decay=0)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup="linear", warmup_iters=50,
                 warmup_ratio=1.0 / 3, step=[{lr_step}])
checkpoint_config = dict(interval=1)
log_config = dict(interval=10)
"""


def render_odometry_sequence(seq_root: str, seq: str, gt_dir: str,
                             height: int, n_frames: int,
                             split: str = "odometry") -> None:
    """Drive the simulated camera n_frames meters forward; save PNGs in
    the KITTI odometry layout + GT poses (cam-to-world, 3x4 rows)."""
    from PIL import Image

    from ..data.simulated import (ARGO_CAMERA_HEIGHT, CAMERA_HEIGHT, STEP_M,
                                  _texture, render_frame, scene_calib)
    from ..evaluation.trajectory import save_kitti_poses

    img_dir = os.path.join(seq_root, seq, "image_2")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    K, _, _ = scene_calib(height, height)
    tex_g = _texture(np.random.default_rng(12345))
    tex_w = _texture(np.random.default_rng(12345 + 31))
    wall_z = n_frames * STEP_M + 60.0
    cam_h = ARGO_CAMERA_HEIGHT if split == "argo" else CAMERA_HEIGHT
    poses = []
    for i in range(n_frames):
        z = i * STEP_M
        img, _ = render_frame(tex_g, tex_w, K, height, height, cam_z=z,
                              wall_z=wall_z, cam_height=cam_h)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{i:06d}.png"))
        T = np.eye(4, dtype=np.float64)
        T[2, 3] = z  # camera moves along +z; pose = cam-to-world
        poses.append(T)
    save_kitti_poses(os.path.join(gt_dir, f"{seq}.txt"), np.asarray(poses))


def main(argv=None):
    p = argparse.ArgumentParser(description="End-to-end acceptance run")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--type", dest="mtype", default="static",
                   choices=["static", "dynamic", "Argo_both"],
                   help="model/data type: road branch (static), vehicle "
                        "branch + dynamic CGT (dynamic), or dual-branch "
                        "Argoverse semantics with the both-kind CGT and "
                        "0.33 m camera height (Argo_both)")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--n_scenes", type=int, default=64)
    p.add_argument("--imgs_per_gpu", type=int, default=2)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--odom_frames", type=int, default=150)
    p.add_argument("--skip_train", action="store_true",
                   help="reuse an existing checkpoint in work_dir")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    wd = args.work_dir
    os.makedirs(wd, exist_ok=True)
    seq_root = os.path.join(wd, "seq")
    cfg_path = os.path.join(wd, "sim_acceptance.py")
    split = "argo" if args.mtype.startswith("Argo") else "odometry"
    with open(cfg_path, "w") as f:
        f.write(CFG_TEMPLATE.format(
            height=args.height, n_scenes=args.n_scenes,
            imgs_per_gpu=args.imgs_per_gpu, epochs=args.epochs,
            lr_step=max(1, args.epochs * 3 // 4), seq_root=seq_root,
            mtype=args.mtype, split=split,
            cgt_hw=(375, 1242) if args.height >= 256 else (94, 310)))

    results: dict = {"config": cfg_path, "type": args.mtype}

    # -- stage 1: train through the real CLI -------------------------------
    if not args.skip_train:
        from . import train as train_cli

        train_cli.main(["--config", cfg_path, "--work_dir", wd]
                       + ([] if args.device is None else ["--device", args.device]))

    # -- stage 2: the newest checkpoint's weights + eval metrics ------------
    from ..config import Config
    from ..data import DataLoader, get_dataset
    from ..engine.checkpoint import latest_epoch, load_weights
    from ..engine.eval_hook import EvalHook
    from ..models import build_model

    cfg = Config.fromfile(cfg_path)
    model = build_model(cfg.model)
    epoch = latest_epoch(wd)
    load_weights(wd, model, epoch=epoch)
    results["restored_epoch"] = epoch
    val_loader = DataLoader(get_dataset(cfg.data, training=False), batch_size=1,
                            shuffle=False, num_workers=2, drop_last=False)
    metrics = EvalHook(model, val_loader, cfg.model, device=args.device)(None, epoch)
    results["eval"] = {k: round(float(v), 4) for k, v in metrics.items()}

    # -- stage 3: odometry sequence through the real CLI -------------------
    seq = "21"
    gt_dir = os.path.join(wd, "gt_pose")
    render_odometry_sequence(seq_root, seq, gt_dir, args.height,
                             args.odom_frames, split=split)
    from . import draw_odometry as draw_cli

    odom = draw_cli.main([
        "--config", cfg_path, "--checkpoint", wd, "--sequence", seq,
        "--gt_dir", gt_dir, "--out", os.path.join(wd, "odom")]
        + ([] if args.device is None else ["--device", args.device]))
    if odom:
        results["odometry"] = {
            k: round(float(v), 4) for k, v in odom.items()
            if isinstance(v, (int, float))}

    out_path = os.path.join(wd, "acceptance.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
