"""Model complexity: parameters and FLOPs per submodule (counterpart of
`jperceiver_tpu/tools/complexity.py`).

The eval forward (both BEV branches, with pose) runs on PyTorch's meta
device under `torch.utils.flop_counter.FlopCounterMode`: shapes only, no
data and no card, so it takes seconds at any size. FLOPs are those of the
convolutions and matrix products (2 per multiply-add), which is what the
counter counts; elementwise work is not counted (XLA's cost analysis, the
JAX tool's source, counts it too, so the two totals differ).

  python -m jperceiver_tpu_torch.tools.complexity [--height 1024] [--width 1024]
"""

from __future__ import annotations

import argparse


def count(height: int = 1024, width: int = 1024, batch: int = 1,
          depth_layers: int = 18) -> dict:
    """{"params": {submodule: n}, "flops": {submodule: n}, "total_params",
    "total_flops"} of the JPerceiver (both BEV branches) at that input
    size, per child module of the model."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import JPerceiver

    occ = height // 4
    with torch.device("meta"):
        model = JPerceiver(depth_layers=depth_layers, height=height, width=width,
                           occ_map_size=occ)
    model.eval()
    params = {name: sum(p.numel() for p in child.parameters())
              for name, child in model.named_children()}
    counter = FlopCounterMode(display=False, depth=None)
    with counter, torch.no_grad():
        model({"color_aug": torch.empty(batch, 3, 3, height, width, device="meta")},
              with_pose=True)
    by_module = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
    root = type(model).__name__
    flops = {}
    for name in params:
        prefix = f"{root}.{name}"
        # A child entered through a method other than forward (the depth
        # decoder's `decode`) has no entry of its own; its children do.
        flops[name] = by_module.get(prefix, sum(
            n for k, n in by_module.items()
            if k.startswith(prefix + ".") and k.count(".") == prefix.count(".") + 1))
    return {"params": params, "flops": flops, "total_params": sum(params.values()),
            "total_flops": counter.get_total_flops()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="JPerceiver parameters and FLOPs per submodule")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--depth_layers", type=int, default=18)
    p.add_argument("--batch", type=int, default=1)
    args = p.parse_args(argv)
    res = count(args.height, args.width, args.batch, args.depth_layers)
    total = res["total_params"]
    print(f"{'submodule':<32}{'params':>14}{'params %':>10}{'GFLOP':>12}")
    for name, n in sorted(res["params"].items(), key=lambda r: -r[1]):
        print(f"{name:<32}{n:>14,}{100 * n / total:>9.1f}%{res['flops'][name] / 1e9:>12.2f}")
    print(f"{'TOTAL':<32}{total:>14,}")
    b, h, w = args.batch, args.height, args.width
    tf = res["total_flops"]
    print(f"\nforward FLOPs @ {b}x{h}x{w}: {tf / 1e9:.2f} GFLOP ({tf / b / 1e9:.2f} per frame)")
    return res


if __name__ == "__main__":
    main()
