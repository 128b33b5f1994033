"""Streaming video inference demo: depth | layouts | odometry composite
(counterpart of `jperceiver_tpu/tools/video_demo.py`).

Parity with `scripts/eval_kitti_video.py:229-379` /
`eval_argo_both_video.py:209-346`: loop over an image directory, run the
full model on consecutive frame pairs, colorize disparity (magma), argmax
the two BEV layouts, accumulate the trajectory, and write a composite
panel video. One dual-branch model covers both the KITTI two-checkpoint
flow and the Argo single-model flow.

  python -m jperceiver_tpu_torch.tools.video_demo --config cfg.py \
      --checkpoint work_dir --images <dir> --out demo.avi
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def colorize_disp(disp: np.ndarray) -> np.ndarray:
    """(h, w) disparity -> (h, w, 3) uint8 magma-like colormap via cv2."""
    import cv2

    d = disp / (np.percentile(disp, 95) + 1e-8)
    d = np.clip(d, 0, 1)
    return cv2.applyColorMap((d * 255).astype(np.uint8), cv2.COLORMAP_MAGMA)


def layout_to_rgb(mask: np.ndarray, color=(0, 120, 255)) -> np.ndarray:
    out = np.full((*mask.shape, 3), 255, np.uint8)
    out[mask > 0] = color
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--checkpointB", default=None,
                   help="optional second checkpoint whose VEHICLE branch "
                        "replaces topviewB (the reference KITTI demo runs a "
                        "road model + a separate vehicle model, "
                        "eval_kitti_video.py:234-244)")
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    import cv2
    import torch

    from .._device import resolve_device
    from ..config import Config
    from ..data.kitti import pil_open_rgb
    from ..data.transforms import resize_image, to_array
    from ..engine.checkpoint import load_weights
    from ..models import build_model

    cfg = Config.fromfile(args.config)
    dev = resolve_device(args.device)
    h, w = cfg.model.height, cfg.model.width

    def loaded(path):
        model = build_model(cfg.model)
        load_weights(path, model)
        return model.to(dev).eval()

    model = loaded(args.checkpoint)
    model_b = loaded(args.checkpointB) if args.checkpointB else None

    @torch.inference_mode()
    def predict(model, prev_img, cur_img):
        """2-frame streaming forward (`eval_kitti_video.py:58-85`)."""
        out = model({"color_aug": torch.stack([cur_img, prev_img, cur_img], 1)},
                    train=False, with_pose=False)
        T = model.pose_between(prev_img, cur_img)
        return out["disp/0"], out["topview"], out["topviewB"], T

    frames = sorted(
        f for f in os.listdir(args.images) if f.endswith((".png", ".jpg"))
    )
    if args.max_frames:
        frames = frames[: args.max_frames]

    def load(f):
        img = to_array(resize_image(pil_open_rgb(os.path.join(args.images, f)), h, w))
        return torch.from_numpy(img).permute(2, 0, 1)[None].to(dev)

    panel_h = 256
    writer = None
    traj = [np.eye(4)]
    prev = load(frames[0])
    for f in frames[1:]:
        cur = load(f)
        disp, top, topB, T = predict(model, prev, cur)
        if model_b is not None:  # vehicle branch from the second model
            _, _, topB, _ = predict(model_b, prev, cur)
        traj.append(traj[-1] @ np.linalg.inv(T[0].double().cpu().numpy()))
        prev = cur

        rgb = (cur[0].permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)[:, :, ::-1]
        d = colorize_disp(disp[0, 0].cpu().numpy())
        road = layout_to_rgb(top[0].argmax(0).cpu().numpy())
        veh = layout_to_rgb(topB[0].argmax(0).cpu().numpy(), color=(255, 60, 0))

        def rs(img):
            return cv2.resize(img, (int(panel_h * img.shape[1] / img.shape[0]), panel_h))

        xs = np.asarray([t[0, 3] for t in traj])
        zs = np.asarray([t[2, 3] for t in traj])
        plot = np.full((panel_h, panel_h, 3), 255, np.uint8)
        if len(xs) > 1:
            span = max(xs.max() - xs.min(), zs.max() - zs.min(), 1e-3)
            px = ((xs - xs.min()) / span * (panel_h - 20) + 10).astype(int)
            pz = (panel_h - 10 - (zs - zs.min()) / span * (panel_h - 20)).astype(int)
            for i in range(1, len(px)):
                cv2.line(plot, (px[i - 1], pz[i - 1]), (px[i], pz[i]), (200, 0, 0), 2)

        panel = np.concatenate([rs(rgb), rs(d), rs(road), rs(veh), plot], axis=1)
        if writer is None:
            fourcc = cv2.VideoWriter_fourcc(*"MJPG")
            writer = cv2.VideoWriter(args.out, fourcc, args.fps,
                                     (panel.shape[1], panel.shape[0]))
        writer.write(panel)

    if writer is not None:
        writer.release()
    print(f"wrote {len(frames) - 1} frames -> {args.out}")


if __name__ == "__main__":
    main()
