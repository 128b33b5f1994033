"""A `torch.profiler` trace of the training step, with a wall-clock summary
(counterpart of `jperceiver_tpu/tools/profile_step.py`).

One warm-up step, then `--steps` steps under the profiler (host and, on the
card, device activity), written as a Chrome trace to `<out>/trace.json`;
`tools/trace_summary.py` reads it.

  python -m jperceiver_tpu_torch.tools.profile_step --out /tmp/trace [--steps 5]
      [--config preset.py] [--height 1024] [--kernels on|off] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

_EPILOG = (
    "--kernels stands for the JAX tool's --pallas-conv and --pallas-reproj: on "
    "sends the step to the hand kernels K1-K5 and the pool backwards (the port's "
    "default), off to cuDNN and the plain PyTorch versions. The JAX tool's "
    "TPU-lowering flags --dots, --u8-taps and --fold-upconv have no counterpart "
    "here: the port computes those functions in their plain form.")


def flagship_cfg(h: int, w: int) -> dict:
    """bench.py's flagship step: road branch, B=1, bf16, Adam 1e-4, clip 35."""
    return dict(type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
                height=h, width=w, occ_map_size=h // 4, num_class=2, min_depth=0.1,
                max_depth=100.0, automask=True, disp_norm=True, smoothness_weight=1e-3,
                scale_weight=0.1, static_weight=5.0, dynamic_weight=15.0, loss_type="iou",
                loss_sum=3, loss_weight=20, loss2_weight=20, loss_weightS=20,
                loss2_weightS=20, cgt_label_hw=(375, 1242), compute_dtype="bfloat16",
                optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
                optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
                lr_config=dict(policy="step", warmup=None, step=[50]), name="JPerceiver")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Profile the training step (PyTorch port)",
                                epilog=_EPILOG)
    p.add_argument("--config", default=None, help="preset path; default bench.py's flagship")
    p.add_argument("--out", required=True, help="directory for trace.json")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--height", type=int, default=None,
                   help="input height and width (occ = height / 4)")
    p.add_argument("--kernels", choices=("on", "off"), default="on")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .._device import resolve_device
    from ..config import Config
    from ..data import synthetic_batch
    from ..engine import make_train_step
    from ..models import build_model
    from ..models.common import set_kernels

    device = resolve_device(args.device)
    optim_cfg = None
    if args.config:
        cfg = Config.fromfile(args.config)
        model_cfg, optim_cfg = cfg.model, cfg
        for key in ("type", "split"):
            model_cfg.setdefault(key, cfg.data.get(key, "static"))
    else:
        model_cfg = Config.fromdict(flagship_cfg(1024, 1024))
    if args.height:
        model_cfg.height = model_cfg.width = args.height
        model_cfg.occ_map_size = args.height // 4
    on = args.kernels == "on"
    model_cfg.use_pallas_conv = model_cfg.use_pallas_conv_deep = on
    model_cfg.use_pallas_reproj = on
    h, w, occ = model_cfg.height, model_cfg.width, model_cfg.occ_map_size

    torch.manual_seed(0)
    model = build_model(model_cfg)
    step = make_train_step(model, model_cfg, device, steps_per_epoch=1000, optim_cfg=optim_cfg)
    set_kernels(model, on, on, on, stem_pool=on)
    batch = synthetic_batch(1, h, w, occ)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Warm-up: the first step runs eagerly (kernel builds, cuDNN plans, the
    # allocator), the second captures the step's CUDA graph on the card; the
    # traced steps are replays.
    for _ in range(2):
        float(step(batch)["loss"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = step(batch)
        loss = float(m["loss"])
        sync()
        dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(trace)
    ms = dt / args.steps * 1e3
    print(f"traced {args.steps} steps at 1x{h}x{w}, kernels {args.kernels}: "
          f"{ms:.1f} ms/step (host clock, profiler on), loss {loss:.4f} -> {trace}")
    return {"ms_per_step": ms, "trace": trace, "steps": args.steps, "loss": loss}


if __name__ == "__main__":
    main()
