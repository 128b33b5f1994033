#!/usr/bin/env python3
"""Tile-plan sweep of the bf16 3x3-conv kernels K3 and K4 on one GPU.

    python3 chip_conv_sweep.py

At every K3 site shape of the 1024^2 training step, times the kernels
through their C entry points, bypassing the tile plans, at each output-tile
width (K3, forward and data-grad) and at each width and pixel-split count
(K4, every result checked against its plain version), beside the plan's
own choice and cuDNN. For the 513-channel concat it also times K3 with the
operand stored 520 wide (16-byte strides) and 576 wide (whole 128-byte
rows). Times are device times of back-to-back calls queued behind a spin
kernel (`chip_smoke.py::time_ms`). Prints one JSON line a site; all of it
goes to chiprun_out/conv_sweep.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (c_in, c_out, output extent, pad) of the step's K3 sites.
SITES = [(64, 64, 256, 1), (128, 128, 128, 1), (256, 256, 64, 1), (513, 256, 64, 0),
         (256, 256, 128, 0), (513, 256, 128, 0), (256, 256, 256, 0), (513, 256, 256, 0)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (_ceil, _stream, _strides, _tma_operand,
                                                       _weight_operand, k3_plan, k4_plan)

    torch.backends.cudnn.allow_tf32 = False
    lib = _build.library()
    grad = torch.nn.grad
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def k3_raw(xh, wk, ys, h, c, o, pad, plan, bn):
        def run():
            err = lib.jp_conv3x3_fwd_bf16(
                xh.data_ptr(), wk.data_ptr(), None, ys.data_ptr(), 1, h, h, c, *_strides(xh),
                wk.shape[3], o, ys.shape[3], pad, plan.box_w, plan.box_h, bn, 0, _stream(xh))
            _build.check(err, "conv3x3")
        return time_ms(torch, run)

    for c, o, e, pad in SITES:
        hin = e + 2 - 2 * pad
        x = torch.randn(1, c, hin, hin, device="cuda", generator=g).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)).bfloat16()
        gy = torch.randn(1, o, e, e, device="cuda", generator=g).bfloat16()
        gy = gy.contiguous(memory_format=torch.channels_last)
        row = {"site": [c, o, e, pad], "card": card}

        # K3 forward: every width; for 513 channels both channel strides.
        p = k3_plan(1, hin, hin, c, o, pad)
        row["k3_plan"] = [p.box_w, p.box_h, p.bn]
        row["k3_cudnn_ms"] = time_ms(torch, lambda: torch.nn.functional.conv2d(x, w, padding=pad))
        wk = _weight_operand(w, torch.bfloat16)
        ys = torch.empty(1, e, e, p.o_store, device="cuda", dtype=torch.bfloat16)
        for stride in sorted({p.c_store, _ceil(c, 8) * 8}):
            buf = torch.empty(1, hin, hin, stride, device="cuda", dtype=torch.bfloat16)
            buf[..., :c].copy_(x.permute(0, 2, 3, 1))
            xs = buf[..., :c]
            for bn in (64, 128, 176, 256):
                row[f"k3_c{stride}_bn{bn}_ms"] = k3_raw(xs, wk, ys, hin, c, o, pad, p, bn)

        # K3 as the data-grad: K3 on the cotangent at pad 2 - pad, c outputs.
        q = k3_plan(1, e, e, o, c, 2 - pad)
        row["dgrad_plan"] = [q.box_w, q.box_h, q.bn]
        row["dgrad_cudnn_ms"] = time_ms(
            torch, lambda: grad.conv2d_input(x.shape, w, gy, padding=pad))
        wt = _weight_operand(w.flip(2, 3).transpose(0, 1), torch.bfloat16)
        yd = torch.empty(1, hin, hin, q.o_store, device="cuda", dtype=torch.bfloat16)
        gh = _tma_operand(gy)
        for bn in (64, 128, 176, 256):
            row[f"dgrad_bn{bn}_ms"] = k3_raw(gh, wt, yd, e, o, c, 2 - pad, q, bn)

        # K4: every width and split count that fits one wave or two.
        r = k4_plan(1, hin, hin, c, o, pad)
        row["k4_plan"] = [r.bn, r.splits]
        row["k4_cudnn_ms"] = time_ms(
            torch, lambda: grad.conv2d_weight(x, w.shape, gy, padding=pad))
        xh = _tma_operand(x)
        ref = conv3x3_wgrad_plain(x, gy, pad)
        for bn in (64, 128, 256):
            base = _ceil(9 * r.kchunks, 2) * _ceil(o, bn)
            for splits in sorted({1, 2, 3, 4, 6, 8, 12, 16, 26, max(1, 132 // base)}):
                per = _ceil(r.tiles, splits)
                splits = _ceil(r.tiles, per)
                if splits * base > 264:
                    continue
                part = torch.empty(splits, 9, 64 * r.kchunks, bn * _ceil(o, bn), device="cuda")
                out = torch.empty(o, c, 3, 3, device="cuda")

                def run():
                    err = lib.jp_conv3x3_wgrad_bf16(
                        xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), 1, hin,
                        hin, c, *_strides(xh), o, *_strides(gh), pad, r.box_w, r.box_h, bn,
                        splits, per, _stream(xh))
                    _build.check(err, "conv3x3_wgrad")

                run()
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                if not err <= 1e-4:
                    raise AssertionError(f"K4 at {row['site']} bn {bn} splits {splits}: {err}")
                row[f"k4_bn{bn}_s{splits}_ms"] = time_ms(torch, run)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, gy, xh, gh
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "conv_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
