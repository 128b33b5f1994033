#!/usr/bin/env python3
"""Tile-plan sweep of the bf16 3x3-conv kernels K3 and K4 on one GPU.

    python3 chip_conv_sweep.py            # tile widths and splits
    python3 chip_conv_sweep.py --k4-flush [--parent DIR]
                                          # K4's accumulator flush interval

At every K3 site shape of the 1024^2 training step, times the kernels
through their C entry points, bypassing the tile plans, at each output-tile
width (K3, forward and data-grad) and at each width and pixel-split count
(K4, 64 and 128 wide, every result checked against its plain version), beside the plan's
own choice and cuDNN. For the 513-channel concat it also times K3 with the
operand stored 520 wide (16-byte strides) and 576 wide (whole 128-byte
rows). Times are device times of back-to-back calls queued behind a spin
kernel (`chip_smoke.py::time_ms`). Prints one JSON line a site; all of it
goes to chiprun_out/conv_sweep.json. Exits non-zero without a CUDA device.

`--k4-flush` runs K4 at B = 3 (the preset fit's batch) and B = 8 at every
site, through its C entry point on the plan's tiles and splits, at each
interval of tiles after which the kernel adds its `wgmma` accumulator into
its second fp32 sum (the split's whole length: one add at the end, the
accumulator alone), then at the plan's interval on other split counts (one
wave of blocks, half and twice the plan's), beside cuDNN's conv2d_weight. Each run gives the
largest distance to float64 (cuDNN in fp64 on the same bf16 inputs) over
the largest |dW|, beside the plain version's, and its device time; each is
run twice and held bit for bit. At 513 -> 256 @ 256^2 it also sums the same
64-pixel tile products in the same chains with PyTorch's fp32 adds (round
to nearest), which tells an accumulator that loses precision in its own
adds from error that any fp32 chain of that length would have. Output:
chiprun_out/k4_flush.json. With `--parent DIR` (another checkout, such
as the parent commit unpacked) it also builds and times that checkout's K4
on its own plan (256 wide, splits that fill one wave, no second sum) in
the same run.
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


def parent_k4(parent: str):
    """K4 as another checkout (`parent`, e.g. the parent commit unpacked)
    has it: its conv3x3_wgrad.cu built alone with nvcc and bound with ctypes,
    with the C interface before the flush argument."""
    import ctypes
    import subprocess

    from jperceiver_tpu_torch.ops.cuda import _build
    from torch.utils.cpp_extension import CUDA_HOME

    csrc = os.path.join(parent, "jperceiver_tpu_torch", "ops", "cuda", "csrc")
    build = os.path.join(_build.BUILD_DIR, "parent_k4")
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, "wgrad.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.NVCC_FLAGS, "-shared",
                    "-Xcompiler", "-fPIC", "-I", csrc, "-o", so,
                    os.path.join(csrc, "conv3x3_wgrad.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jp_conv3x3_wgrad_bf16.argtypes = (P, P, P, P, I, I, I, I, L, L, L, I, L, L, L) + (I,) * 6 \
        + (P,)
    lib.jp_conv3x3_wgrad_bf16.restype = I
    return lib


def k4_flush_sweep(torch, parent: str | None = None) -> list[dict]:
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (_ceil, _stream, _strides, _tma_operand,
                                                       k4_plan)

    lib = _build.library()
    plib = parent_k4(parent) if parent else None
    report = _build.ptxas_report()
    print(report[report.index("== conv3x3_wgrad.cu"):report.index("== maxpool5x5.cu")], flush=True)
    grad = torch.nn.grad
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    cases = [(3, site) for site in SITES] + [(8, (513, 256, 256, 0)), (8, (64, 64, 256, 1))]
    for bsz, (c, o, e, pad) in cases:
        hin = e + 2 - 2 * pad
        x = torch.randn(bsz, c, hin, hin, device="cuda", generator=g).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        gy = torch.randn(bsz, o, e, e, device="cuda", generator=g).bfloat16()
        gy = gy.contiguous(memory_format=torch.channels_last)
        p = k4_plan(bsz, hin, hin, c, o, pad)
        xh, gh = _tma_operand(x), _tma_operand(gy)
        dw64 = grad.conv2d_weight(x.double(), (o, c, 3, 3), gy.double(), padding=pad)
        scale = dw64.abs().max().item()
        plain = conv3x3_wgrad_plain(x, gy, pad)
        row = {"card": card, "batch": bsz, "site": [c, o, e, pad], "bn": p.bn,
               "splits": p.splits, "tiles_per_split": p.tiles_per_split,
               "plan_flush_tiles": p.flush_tiles,
               "plain_err_f64": (plain.double() - dw64).abs().max().item() / scale}
        row["cudnn_ms"] = time_ms(torch, lambda: grad.conv2d_weight(
            x, (o, c, 3, 3), gy, padding=pad), reps=10)
        if plib is not None:
            # The parent's plan: the widest tile, splits that fill one wave.
            bn0 = 256 if o % 256 == 0 else p.bn
            splits0 = max(1, min(132 // (_ceil(9 * p.kchunks, 2) * _ceil(o, bn0)), p.tiles // 16))
            per0 = _ceil(p.tiles, splits0)
            splits0 = _ceil(p.tiles, per0)
            part0 = torch.empty(splits0, 9, 64 * p.kchunks, bn0 * _ceil(o, bn0), device="cuda")
            out0 = torch.empty(o, c, 3, 3, device="cuda")

            def run_parent():
                err = plib.jp_conv3x3_wgrad_bf16(
                    xh.data_ptr(), gh.data_ptr(), part0.data_ptr(), out0.data_ptr(), bsz, hin,
                    hin, c, *_strides(xh), o, *_strides(gh), pad, p.box_w, p.box_h, bn0,
                    splits0, per0, _stream(xh))
                _build.check(err, "parent conv3x3_wgrad")

            run_parent()
            torch.cuda.synchronize()
            row["parent_bn_splits"] = [bn0, splits0]
            row["parent_err_f64"] = (out0.double() - dw64).abs().max().item() / scale
            row["parent_over_plain"] = row["parent_err_f64"] / row["plain_err_f64"]
            row["parent_ms"] = time_ms(torch, run_parent, reps=10)
            del part0
        blocks = _ceil(9 * p.kchunks, 2) * p.n_tiles
        # The plan's splits at every flush interval, then the plan's interval
        # at other split counts: one wave, half and twice the plan's.
        runs = [(p.splits, t) for t in sorted({2, 4, 8, 16, 32, p.flush_tiles,
                                                p.tiles_per_split}) if t <= p.tiles_per_split]
        runs += [(s, p.flush_tiles) for s in sorted({max(1, 132 // blocks), max(1, p.splits // 2),
                                                     2 * p.splits} - {p.splits})
                 if s <= max(1, p.tiles // 16)]
        for splits, flush in runs:
            bn, per = p.bn, _ceil(p.tiles, splits)
            splits = _ceil(p.tiles, per)
            flush = min(flush, per)
            name = f"s{splits}_flush{flush}"
            part = torch.empty(splits, 9, 64 * p.kchunks, bn * _ceil(o, bn), device="cuda")
            outs = [torch.empty(o, c, 3, 3, device="cuda") for _ in range(2)]

            def run(out=outs[0]):
                err = lib.jp_conv3x3_wgrad_bf16(
                    xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), bsz, hin,
                    hin, c, *_strides(xh), o, *_strides(gh), pad, p.box_w, p.box_h, bn,
                    splits, per, flush, _stream(xh))
                _build.check(err, "conv3x3_wgrad")

            run(outs[0])
            run(outs[1])
            torch.cuda.synchronize()
            if not torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)):
                raise AssertionError(f"K4 differs between two runs at {row['site']} B {bsz} "
                                     f"{name}")
            err = (outs[0].double() - dw64).abs().max().item() / scale
            row[f"{name}_err_f64"] = err
            row[f"{name}_over_plain"] = err / row["plain_err_f64"]
            row[f"{name}_ms"] = time_ms(torch, run, reps=10)
            del part
        if (c, o, e, pad) == (513, 256, 256, 0) and bsz == 3:
            # The plan's chains summed with round-to-nearest fp32 adds: one
            # fp32 product of 64 pixels a tile (TF32 off), added in tile order.
            cols = torch.nn.functional.unfold(x.float(), 3)  # (B, 9C, pixels)
            cols = cols.transpose(1, 2).reshape(-1, 9 * c)   # pixels in tile order
            gf = gy.float().permute(0, 2, 3, 1).reshape(-1, o)
            total = torch.zeros(9 * c, o, device="cuda")
            for sp in range(p.splits):
                acc = torch.zeros(9 * c, o, device="cuda")
                t0 = sp * p.tiles_per_split
                for t in range(t0, min(p.tiles, t0 + p.tiles_per_split)):
                    acc += cols[64 * t:64 * t + 64].T @ gf[64 * t:64 * t + 64]
                total += acc
            dw_rn = total.reshape(c, 9, o).permute(2, 0, 1).reshape(o, c, 3, 3)
            row["rn_chain_err_f64"] = (dw_rn.double() - dw64).abs().max().item() / scale
            del cols, gf, total, acc
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, gy, xh, gh, dw64, plain
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (K4_CHAIN, _ceil, _stream, _strides,
                                                       _tma_operand, _weight_operand, k3_plan,
                                                       k4_plan)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--k4-flush" in sys.argv[1:]:
        args = sys.argv[1:]
        rows = k4_flush_sweep(torch, args[args.index("--parent") + 1] if "--parent" in args
                              else None)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k4_flush.json"), "w") as f:
            json.dump(rows, f, indent=1)
        return 0
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
        for bn in (64, 128):
            base = _ceil(9 * r.kchunks, 2) * _ceil(o, bn)
            for splits in sorted({1, 2, 3, 4, 6, 8, 12, 16, 26, max(1, 132 // base)}):
                per = _ceil(r.tiles, splits)
                splits = _ceil(r.tiles, per)
                flush = min(K4_CHAIN // 4, per)
                if splits * base > 264:
                    continue
                part = torch.empty(splits, 9, 64 * r.kchunks, bn * _ceil(o, bn), device="cuda")
                out = torch.empty(o, c, 3, 3, device="cuda")

                def run():
                    err = lib.jp_conv3x3_wgrad_bf16(
                        xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), 1, hin,
                        hin, c, *_strides(xh), o, *_strides(gh), pad, r.box_w, r.box_h, bn,
                        splits, per, flush, _stream(xh))
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
