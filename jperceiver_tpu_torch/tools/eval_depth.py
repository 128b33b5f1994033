"""Offline Eigen-split depth evaluation (counterpart of
`jperceiver_tpu/tools/eval_depth.py`): the depth net over the val split,
median scaling, the Eigen crop, depth clamped to [1e-3, 80]; prints the
7-column table and the scaling ratios' median and spread.

    python -m jperceiver_tpu_torch.tools.eval_depth --config cfg.py \
        --checkpoint work_dir [--epoch N]
"""

from __future__ import annotations

import argparse

import numpy as np

METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def main(argv=None):
    """Returns the mean of the 7 metrics over the split's samples, or None
    when the split has no ground-truth depth."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="a work dir with checkpoints/, or a checkpoint file")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from ..config import Config
    from ..data import DataLoader, get_dataset
    from ..engine.checkpoint import load_weights
    from ..engine.eval_hook import depth_metrics_single
    from ..engine.infer import make_eval_step
    from ..models import build_model

    cfg = Config.fromfile(args.config)
    model = build_model(cfg.model)
    load_weights(args.checkpoint, model, epoch=args.epoch)
    eval_step = make_eval_step(model, cfg.model, args.device)
    loader = DataLoader(get_dataset(cfg.data, training=False), batch_size=1, shuffle=False,
                        num_workers=4)
    rows, ratios = [], []
    for bi, batch in enumerate(loader):
        if args.max_batches and bi >= args.max_batches:
            break
        gt = batch.pop("gt_depth", None)
        if gt is None:
            continue
        disp = eval_step(batch)["disp/0"][:, 0].cpu().numpy()
        for i in range(disp.shape[0]):
            m = depth_metrics_single(disp[i], gt[i], cfg.data.get("stereo_scale", False))
            if m:
                ratios.append(m.pop("ratio"))
                rows.append([m[k] for k in METRICS])

    if not rows:
        print("no ground-truth depth found in the val split "
              "(set data.raw_calib_root / use a velodyne-equipped split)")
        return None
    rows, ratios = np.asarray(rows), np.asarray(ratios)
    print(("{:>10}" * 7).format(*METRICS))
    print(("{:10.3f}" * 7).format(*rows.mean(axis=0)))
    print(f" Scaling ratios | med: {np.median(ratios):.3f} | "
          f"std: {np.std(ratios / np.median(ratios)):.3f}")
    return rows.mean(axis=0)


if __name__ == "__main__":
    main()
