#!/usr/bin/env python3
"""Tile-plan sweep of the bf16 3x3-conv kernels K3 and K4 on one GPU.

    python3 chip_conv_sweep.py [--parent DIR]  # tile widths and splits
    python3 chip_conv_sweep.py --k4-anatomy    # what sets a K4 step's time
    python3 chip_conv_sweep.py --k4-flush [--parent DIR]
                                               # K4's second-sum interval
    python3 chip_conv_sweep.py --k3-tf32 [--parent DIR]
                                               # K3's TF32 path
    python3 chip_conv_sweep.py --k4-tf32 [--parent DIR]
                                               # K4's TF32 path

At every K3 site shape of the 1024^2 training step, times K3 through its C
entry point, bypassing the tile plan, at each output-tile width (forward
and data-grad), beside the plan's own choice and cuDNN; for the
513-channel concat also with the operand stored 520 wide (16-byte strides)
and 576 wide (whole 128-byte rows). Then K4 at every site at B = 1 and 3
(`k4_designs`): the plan's tiles at several split counts, every result
checked against its plain version and run twice bit for bit, beside the
plan's choice, cuDNN's conv2d_weight and, with `--parent DIR` (another
checkout, such as the parent commit unpacked), that checkout's K4 on its
own plan (`parent_plan`). Times are device times of back-to-back calls
queued behind a spin kernel (`chip_smoke.py::time_ms`). Prints one JSON
line a site; all of it goes to chiprun_out/conv_sweep.json. Exits non-zero
without a CUDA device.

`--k4-anatomy` builds variants of `csrc/conv3x3_wgrad.cu`, each a
compile-time define in a copy under the build directory (`EDITS`,
`ANATOMY`): loads and barriers only, products on resident stages only, 64
pixels a step, one consumer warpgroup, no second sum, a load a box, and the
two warpgroups' adds staggered. At 256 -> 256 and 513 -> 256 @ 256^2, B = 3,
it gives each one's time and microseconds a block step and per 128 pixels,
then the shipped K4 and cuDNN at every site at B = 1 and 3. Output:
chiprun_out/k4_anatomy.json.

`--k4-flush` runs K4 at B = 1 (the bench step's batch), 3 (the preset fit's)
at every site and at B = 8 at two, through its C entry point on the plan's tiles and splits, at each
interval of tiles after which the kernel adds its `wgmma` accumulator into
its second fp32 sum (the split's whole length: one add at the end, the
accumulator alone), then at the plan's interval on other split counts (one
wave of blocks, half and twice the plan's), beside cuDNN's conv2d_weight.
Each run gives the largest distance to float64 (cuDNN in fp64 on the same
bf16 inputs) over the largest |dW|, beside the plain version's, and its
device time; each is run twice and held bit for bit. At 513 -> 256 @ 256^2
it also sums the same tile products in the same chains with PyTorch's fp32
adds (round to nearest), which tells an accumulator that loses precision in
its own adds from error that any fp32 chain of that length would have.
Output: chiprun_out/k4_flush.json. With `--parent DIR` it also times that
checkout's K4 on its own plan in the same run.

`--k3-tf32` times K3's TF32 path through its wrapper (the weight's
rounded copy included) at every site at B = 1 and 3, as the forward and as
the data-grad, beside its bound at 494.7 TFLOP/s and 3.35 TB/s, cuDNN's
TF32 (`allow_tf32` on) and the exact fp32 kernel; K3 and cuDNN each with
its largest distance to float64 of the rounded operands in TF32 gaps (the
largest distance between float64 of the rounded and of the exact
operands). At
the two widest sites at B = 3 it also runs, at 128 wide, the kernel built
with a second fp32 sum every 9 or 36 K steps (`K3_CHAIN_EDITS`) beside the
shipped one at the same width, which tells whether the accumulator's own
adds need one. With `--parent DIR` it holds the bf16 and exact fp32 paths
bit for bit to that checkout's `conv3x3.cu` at every site at B = 1.
Output: chiprun_out/k3_tf32.json.

`--k4-tf32` times K4's TF32 path through its wrapper (on the forward's
saved operand, as the backward calls it) at every site at B = 1 and 3,
beside its bound at 494.7 TFLOP/s and 3.35 TB/s, cuDNN's TF32
`conv2d_weight` (`allow_tf32` on) and the exact fp32 kernel; K4 and cuDNN
each with its largest distance to float64 of the rounded operands in TF32
gaps (the largest distance between float64 of the rounded and of the exact
operands). Then the plan's tiles at several split counts through the C
entry (each run twice, bit for bit), which is what `k4_plan`'s split model
is fitted to. With `--parent DIR` it holds the bf16 and exact fp32 K4 bit
for bit to that checkout's `conv3x3_wgrad.cu` at every site at B = 1.
Output: chiprun_out/k4_tf32.json.
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (c_in, c_out, output extent, pad) of the step's K3 sites.
SITES = [(64, 64, 256, 1), (128, 128, 128, 1), (256, 256, 64, 1), (256, 256, 64, 0),
         (513, 256, 64, 0), (256, 256, 128, 0), (513, 256, 128, 0), (256, 256, 256, 0),
         (513, 256, 256, 0)]


def csrc_of(checkout: str) -> str:
    """The kernels' source directory of a checkout of the repo."""
    return os.path.join(checkout, "jperceiver_tpu_torch", "ops", "cuda", "csrc")


def build_alone(csrc: str, source: str, name: str, text: str | None = None):
    """`source` of `csrc` (this or another checkout's, `csrc_of`), or `text`
    in its place, built alone with nvcc into the build directory's `name`
    and bound with ctypes as `_build` binds the kernels' library: K4 of the
    parent commit (`parent_plan`), whose entry has this checkout's
    interface, or a variant of K3."""
    import ctypes
    import subprocess

    from jperceiver_tpu_torch.ops.cuda import _build
    from torch.utils.cpp_extension import CUDA_HOME

    build = os.path.join(_build.BUILD_DIR, name)
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, source.replace(".cu", ".so"))
    path = os.path.join(csrc, source)
    if text is not None:
        path = os.path.join(build, source)
        with open(path, "w") as f:
            f.write(text)
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.NVCC_FLAGS, "-shared",
                    "-Xcompiler", "-fPIC", "-I", csrc, "-o", so, path], check=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


# K3-TF32 with a second fp32 sum that takes the accumulator every K3_CHAIN K
# steps (run at tiles of 128 channels: two accumulator sets in registers),
# as edits of a copy of `csrc/conv3x3.cu`: (text, what replaces it).
K3_CHAIN_EDITS = [
    ("    uint32_t a[BK / 8][4];\n",
     "    uint32_t a[BK / 8][4];\n    float sum[BN / 2] = {};\n"),
    ("      if (lane == 0) jp::mbar_arrive(&empty[s]);\n    }\n    jp::fence_accumulator(acc);\n",
     "      if (lane == 0) jp::mbar_arrive(&empty[s]);\n"
     "      if ((i + 1) % K3_CHAIN == 0) {\n"
     "        jp::fence_accumulator(acc);\n"
     "#pragma unroll\n"
     "        for (int r = 0; r < BN / 2; ++r) { sum[r] += acc[r]; acc[r] = 0.0f; }\n"
     "        jp::fence_accumulator(acc);\n"
     "      }\n"
     "    }\n"
     "    jp::fence_accumulator(acc);\n"
     "#pragma unroll\n"
     "    for (int r = 0; r < BN / 2; ++r) acc[r] += sum[r];\n"),
]


def k3_chain_copy(src: str, chain: int) -> str:
    """`conv3x3.cu`'s text with K3_CHAIN_EDITS made, the sum every `chain` K
    steps."""
    for old, new in K3_CHAIN_EDITS:
        if src.count(old) != 1:
            raise ValueError(f"K3_CHAIN_EDITS: not found once in conv3x3.cu: {old!r}")
        src = src.replace(old, new)
    return src.replace("K3_CHAIN", str(chain))


def k3_tf32_sweep(torch, parent: str | None = None) -> list[dict]:
    import torch.nn.functional as F

    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build
    from jperceiver_tpu_torch.ops.cuda import conv3x3 as k3

    csrc = csrc_of(ROOT)
    own = _build.library
    lib = own()
    with open(os.path.join(csrc, "conv3x3.cu")) as f:
        text = f.read()
    chains = {n: build_alone(csrc, "conv3x3.cu", f"k3_chain{n}", k3_chain_copy(text, n))
              for n in (9, 36)}
    plib = build_alone(csrc_of(parent), "conv3x3.cu", "parent_k3") if parent else None
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(16)
    grad = torch.nn.grad
    rows = []

    def gaps(y, x, w, pad):
        """y's largest distance to float64 of the rounded operands, in TF32 gaps."""
        ref = F.conv2d(k3.round_tf32(x).double(), k3.round_tf32(w).double(), padding=pad)
        gap = (ref - F.conv2d(x.double(), w.double(), padding=pad)).abs().max().item()
        return (y.double() - ref).abs().max().item() / gap

    def raw(lib, x, w, bn, pad):
        """K3-TF32 through `lib`'s C entry point at output width bn."""
        bsz, c, h, wd = x.shape
        o = w.shape[0]
        p = k3.k3_plan(bsz, h, wd, c, o, pad, elem=4)
        xh, wk = k3._tma_operand(x), k3._weight_operand(w, torch.float32, True)
        ys = torch.empty(bsz, p.ho, p.wo, p.o_store, device="cuda")

        def run():
            err = lib.jp_conv3x3_fwd_tf32(xh.data_ptr(), wk.data_ptr(), None, ys.data_ptr(), bsz,
                                          h, wd, c, *k3._strides(xh), wk.shape[3], o, p.o_store,
                                          pad, p.box_w, p.box_h, bn, k3._stream(x))
            _build.check(err, "conv3x3 tf32")
            return ys.permute(0, 3, 1, 2)[:, :o]
        return run

    for bsz in (1, 3):
        for c, o, e, pad in SITES:
            hin = e + 2 - 2 * pad
            x = torch.randn(bsz, c, hin, hin, device="cuda", generator=g)
            x = x.contiguous(memory_format=torch.channels_last)
            w = torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)
            gy = torch.randn(bsz, o, e, e, device="cuda", generator=g)
            gy = gy.contiguous(memory_format=torch.channels_last)
            wt = w.flip(2, 3).transpose(0, 1)
            flops = 2 * bsz * e * e * o * 9 * c
            row = {"card": card, "batch": bsz, "site": [c, o, e, pad],
                   "plan_bn": k3.k3_plan(bsz, hin, hin, c, o, pad, elem=4).bn,
                   "dgrad_plan_bn": k3.k3_plan(bsz, e, e, o, c, 2 - pad, elem=4).bn}
            for name, a, wk, pd, cin, cout, ext_in, ext_out in (
                    ("fwd", x, w, pad, c, o, hin, e), ("dgrad", gy, wt, 2 - pad, o, c, e, hin)):
                byts = 4 * (bsz * ext_in ** 2 * cin + cout * 9 * cin + bsz * ext_out ** 2 * cout)
                row[f"{name}_bound_ms"] = 1e3 * max(flops / 494.7e12, byts / 3.35e12)
                torch.backends.cudnn.allow_tf32 = True
                y = k3._conv(a, wk, None, pd, "conv3x3")
                row[f"{name}_err_gaps"] = gaps(y, a, wk, pd)
                row[f"{name}_tf32_ms"] = time_ms(
                    torch, lambda: k3._conv(a, wk, None, pd, "conv3x3"), reps=10)
                lib_call = (functools.partial(F.conv2d, x, w, padding=pad) if name == "fwd" else
                            functools.partial(grad.conv2d_input, x.shape, w, gy, padding=pad))
                row[f"{name}_cudnn_err_gaps"] = gaps(lib_call(), a, wk, pd)
                row[f"{name}_cudnn_tf32_ms"] = time_ms(torch, lib_call, reps=10)
                torch.backends.cudnn.allow_tf32 = False
                row[f"{name}_f32_ms"] = time_ms(
                    torch, lambda: k3._conv(a, wk, None, pd, "conv3x3"), reps=10)
                row[f"{name}_share"] = row[f"{name}_bound_ms"] / row[f"{name}_tf32_ms"]
                if bsz == 3 and name == "fwd" and e == 256 and pad == 0:
                    for n, clib in [(0, lib), *chains.items()]:
                        run = raw(clib, a, wk, 128, pd)
                        row[f"chain{n}_bn128_err_gaps"] = gaps(run(), a, wk, pd)
                        row[f"chain{n}_bn128_ms"] = time_ms(torch, run, reps=10)
                if plib is not None and bsz == 1:
                    # bf16 and exact fp32 against the other checkout's kernels,
                    # launched by this wrapper with its library swapped in.
                    torch.backends.cudnn.allow_tf32 = False
                    for dtype in (torch.bfloat16, torch.float32):
                        ad, wd = a.to(dtype), wk.to(dtype)
                        ours = k3._conv(ad, wd, None, pd, "conv3x3")
                        _build.library = lambda: plib
                        try:
                            theirs = k3._conv(ad, wd, None, pd, "conv3x3")
                        finally:
                            _build.library = own
                        row[f"{name}_{str(dtype)[6:]}_equal_parent"] = bool(
                            torch.equal(ours.float(), theirs.float()))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, gy, w, wt
            torch.cuda.empty_cache()
    return rows


def k4_tf32_sweep(torch, parent: str | None = None) -> list[dict]:
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build
    from jperceiver_tpu_torch.ops.cuda import conv3x3 as k3

    own = _build.library
    lib = own()
    plib = build_alone(csrc_of(parent), "conv3x3_wgrad.cu", "parent_k4") if parent else None
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(20)
    flags = torch.backends.cudnn
    rows = []

    def wgrad64(x, gy, pad):
        return torch.nn.grad.conv2d_weight(x.double(), (gy.shape[1], x.shape[1], 3, 3),
                                           gy.double(), padding=pad)

    for bsz in (1, 3):
        for c, o, e, pad in SITES:
            hin = e + 2 - 2 * pad
            x = torch.randn(bsz, c, hin, hin, device="cuda", generator=g)
            x = x.contiguous(memory_format=torch.channels_last)
            gy = torch.randn(bsz, o, e, e, device="cuda", generator=g)
            gy = gy.contiguous(memory_format=torch.channels_last)
            xh, gh = k3._tma_operand(x), k3._tma_operand(gy)
            p = k3.k4_plan(bsz, hin, hin, c, o, pad, elem=4)
            flops = 2 * 9 * c * o * bsz * e * e
            byts = 4 * (bsz * hin * hin * c + bsz * e * e * o + o * c * 9)
            ref = wgrad64(k3.round_tf32(x), k3.round_tf32(gy), pad)
            gap = (ref - wgrad64(x, gy, pad)).abs().max().item()
            row = {"card": card, "batch": bsz, "site": [c, o, e, pad],
                   "plan": [p.box_w, p.box_h, p.bn, p.splits, p.tiles_per_split,
                            p.flush_tiles],
                   "bound_ms": 1e3 * max(flops / 494.7e12, byts / 3.35e12)}
            flags.allow_tf32 = True
            dw = k3._wgrad_tma(xh, gy, pad)
            row["err_gaps"] = (dw.double() - ref).abs().max().item() / gap
            row["tf32_ms"] = time_ms(torch, lambda: k3._wgrad_tma(xh, gy, pad), reps=10)
            lib_call = functools.partial(torch.nn.grad.conv2d_weight, x, (o, c, 3, 3), gy,
                                         padding=pad)
            row["cudnn_err_gaps"] = (lib_call().double() - ref).abs().max().item() / gap
            row["cudnn_tf32_ms"] = time_ms(torch, lib_call, reps=10)
            flags.allow_tf32 = False
            row["f32_ms"] = time_ms(torch, lambda: k3.conv3x3_wgrad(x, gy, pad), reps=10)
            row["share"] = row["bound_ms"] / row["tf32_ms"]
            out = torch.empty(o, c, 3, 3, device="cuda")
            blocks = -(-9 * p.kchunks // 2) * p.n_tiles
            wave = max(1, 132 // blocks)
            for splits in sorted({1, 2, 3, 4, 6, 8, 11, 13, 16, 26, 39, 52, wave, 2 * wave,
                                  3 * wave, p.splits}):
                if splits > max(1, p.tiles // 8):
                    continue
                per = -(-p.tiles // splits)
                splits = -(-p.tiles // per)
                part = torch.empty(splits, 9, 64 * p.kchunks, p.bn * p.n_tiles, device="cuda")

                def run(splits=splits, per=per, part=part):
                    err = lib.jp_conv3x3_wgrad_tf32(
                        xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), bsz,
                        hin, hin, c, *k3._strides(xh), o, *k3._strides(gh), pad, p.box_w,
                        p.box_h, p.bn, splits, per, min(p.flush_tiles, per), k3._stream(xh))
                    _build.check(err, f"K4 TF32 splits {splits}")

                run()
                first = out.clone()
                run()
                torch.cuda.synchronize()
                if not torch.equal(first.view(torch.int32), out.view(torch.int32)):
                    raise AssertionError(f"K4 TF32 splits {splits} at {row['site']} B {bsz}: "
                                         "two runs differ")
                row[f"s{splits}_ms"] = time_ms(torch, run, reps=10)
                row[f"s{splits}_err_gaps"] = (out.double() - ref).abs().max().item() / gap
                del part
            if plib is not None and bsz == 1:
                # bf16 and exact fp32 against the other checkout's kernels,
                # launched by this wrapper with its library swapped in.
                for dtype in (torch.bfloat16, torch.float32):
                    xd, gd = x.to(dtype), gy.to(dtype)
                    ours = k3.conv3x3_wgrad(xd, gd, pad)
                    _build.library = lambda: plib
                    try:
                        theirs = k3.conv3x3_wgrad(xd, gd, pad)
                    finally:
                        _build.library = own
                    row[f"{str(dtype)[6:]}_equal_parent"] = bool(
                        torch.equal(ours.view(torch.int32), theirs.view(torch.int32)))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, gy, xh, gh, ref, dw
            torch.cuda.empty_cache()
    return rows


def k4_flush_sweep(torch, parent: str | None = None) -> list[dict]:
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (_ceil, _stream, _strides, _tma_operand,
                                                       k4_plan)

    lib = _build.library()
    plib = (build_alone(csrc_of(parent), "conv3x3_wgrad.cu", "parent_k4") if parent
            else None)
    report = _build.ptxas_report()
    print(report[report.index("== conv3x3_wgrad.cu"):report.index("== maxpool5x5.cu")], flush=True)
    grad = torch.nn.grad
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    cases = [(bsz, site) for bsz in (1, 3) for site in SITES] + [(8, (513, 256, 256, 0)),
                                                                (8, (64, 64, 256, 1))]
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
            box_w, box_h, bn0, splits0, per0, flush0 = parent_plan(bsz, hin, c, o, pad)
            part0 = torch.empty(splits0, 9, 64 * p.kchunks, bn0 * _ceil(o, bn0), device="cuda")
            out0 = torch.empty(o, c, 3, 3, device="cuda")

            def run_parent():
                err = plib.jp_conv3x3_wgrad_bf16(
                    xh.data_ptr(), gh.data_ptr(), part0.data_ptr(), out0.data_ptr(), bsz, hin,
                    hin, c, *_strides(xh), o, *_strides(gh), pad, box_w, box_h, bn0,
                    splits0, per0, flush0, _stream(xh))
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
        runs = [(p.splits, t) for t in sorted({1, 2, 4, 8, 16, p.flush_tiles,
                                                p.tiles_per_split}) if t <= p.tiles_per_split]
        runs += [(s, p.flush_tiles) for s in sorted({max(1, 132 // blocks), max(1, p.splits // 2),
                                                     2 * p.splits} - {p.splits})
                 if s <= max(1, p.tiles // 8)]
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
            # fp32 product of a tile's pixels (TF32 off), added in tile order
            # (the tiles are runs of one image row: box_h is 1 here).
            n = p.box_w * p.box_h
            cols = torch.nn.functional.unfold(x.float(), 3)  # (B, 9C, pixels)
            cols = cols.transpose(1, 2).reshape(-1, 9 * c)   # pixels in tile order
            gf = gy.float().permute(0, 2, 3, 1).reshape(-1, o)
            total = torch.zeros(9 * c, o, device="cuda")
            for sp in range(p.splits):
                acc = torch.zeros(9 * c, o, device="cuda")
                t0 = sp * p.tiles_per_split
                for t in range(t0, min(p.tiles, t0 + p.tiles_per_split)):
                    acc += cols[n * t:n * t + n].T @ gf[n * t:n * t + n]
                total += acc
            dw_rn = total.reshape(c, 9, o).permute(2, 0, 1).reshape(o, c, 3, 3)
            row["rn_chain_err_f64"] = (dw_rn.double() - dw64).abs().max().item() / scale
            del cols, gf, total, acc
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, gy, xh, gh, dw64, plain
        torch.cuda.empty_cache()
    return rows


# The two widest sites of the step (256 -> 256 and 513 -> 256 @ 256^2) that
# `--k4-anatomy` takes apart, at the preset fit's B = 3.
ANATOMY_SITES = [(256, 256, 256, 0), (513, 256, 256, 0)]
# Compile-time changes to the bf16 K4, each behind its define: in the copy the
# sweep builds, each text below is wrapped as `#ifdef DEFINE new #else old
# #endif`. Every variant but `entry` is built with K4_KERNEL_ONLY,
# so that its times are the main kernel's alone.
EDITS = {
    "K4_TMA_ONLY": [
        # loads and barriers as shipped, no products
        ("        jp::wgmma_m64k16<BN, 1, 1>(acc, jp::sw128_desc(xa + 2048 * kk, BOX_BYTES, 1024),\n"
         "                                   jp::sw128_desc(ga + 2048 * kk, BOX_BYTES, 1024));\n",
         "        { (void)xa; (void)ga; }\n")],
    "K4_RESIDENT_ONLY": [
        # the ring filled once; the products then run on resident stages with
        # no wait for a load
        ("      for (int i = 0; i < ksteps; ++i) {\n        const int s = i % Cf::STAGES;\n"
         "        if (i >= Cf::STAGES) jp::mbar_wait(&empty[s], ((i / Cf::STAGES) - 1) & 1);\n",
         "      for (int i = 0; i < min(ksteps, Cf::STAGES); ++i) {\n"
         "        const int s = i % Cf::STAGES;\n"),
        ("      jp::mbar_wait(&full[s], (i / Cf::STAGES) & 1);\n",
         "      if (i < Cf::STAGES) jp::mbar_wait(&full[s], (i / Cf::STAGES) & 1);\n")],
    "K4_PX64": [
        # 64 pixels a stage: 4 wgmma a commit, twice the stages
        ("constexpr int BP = 128;       // pixels a K step (a box of box_w x box_h pixels of one image)\n",
         "constexpr int BP = 64;\n")],
    "K4_ONE_CONSUMER": [
        # one consumer warpgroup and one item (tap, chunk) a block, one x load
        ("constexpr int THREADS = 384;", "constexpr int THREADS = 256;"),
        ("  const Items it = block_items(blockIdx.x, kchunks, xpairs);\n",
         "  Items it;\n  it.n = 1;\n  it.paired = false;\n"
         "  it.tap[0] = it.tap[1] = blockIdx.x / kchunks;\n"
         "  it.chunk[0] = it.chunk[1] = blockIdx.x % kchunks;\n"),
        ("  if (wg == 2) {", "  if (wg == 1) {"),
        ("    if (threadIdx.x == 256) {", "    if (threadIdx.x == 128) {"),
        ("  const dim3 grid(9 * xpairs + (9 * left + 1) / 2, o_tiles, splits);",
         "  const dim3 grid(9 * kchunks, o_tiles, splits);")],
    "K4_UNPAIRED": [
        # a load a box: no pair maps, for x nor for g
        ("  const int xpairs = (C / 64) / 2;", "  const int xpairs = 0;"),
        ("  const bool g_paired = BN == 128 && n0 + 128 <= O;", "  const bool g_paired = false;")],
    "K4_KERNEL_ONLY": [
        # the bf16 entry returns after the main kernel, without `sum_splits`
        ("  return static_cast<int>(reduce(partial, out, C, O, 64 * kchunks, o_cols, splits, s));\n",
         "  return 0;\n")],
    "K4_STAGGER": [
        # the two consumer warpgroups add into their second sums on
        # alternate steps, so that one of them always has products queued
        ("      if ((i + 1) % flush_tiles == 0 && i + 1 < ksteps) {\n",
         "      if ((i + 1 + wg) % flush_tiles == 0 && i + 1 < ksteps) {\n")],
}
# variant -> (defines, pixels a stage, no flush). The shipped kernel; (a)-(e):
# loads only, products only, the other step size, one consumer warpgroup, no
# second sum; then a load a box, the whole entry with `sum_splits`, and the
# warpgroups' adds staggered.
ANATOMY = {
    "shipped": ((), 128, False),
    "tma_only": (("K4_TMA_ONLY",), 128, False),
    "resident_only": (("K4_RESIDENT_ONLY",), 128, False),
    "px64": (("K4_PX64",), 64, False),
    "one_consumer": (("K4_ONE_CONSUMER",), 128, False),
    "no_flush": ((), 128, True),
    "unpaired_boxes": (("K4_UNPAIRED",), 128, False),
    # the whole entry, `sum_splits` included
    "entry": ((), 128, False),
    "stagger_flush": (("K4_STAGGER",), 128, False),
}


def anatomy_copy(src: str) -> str:
    """conv3x3_wgrad.cu with every edit behind its define. Raises if a
    text is not there exactly once."""
    head, tail = src.split("extern \"C\" int jp_conv3x3_wgrad_f32", 1)
    for define, edits in EDITS.items():
        for old, new in edits:
            if head.count(old) != 1:
                raise RuntimeError(f"chip_conv_sweep: {define}'s text is not in "
                                   f"conv3x3_wgrad.cu once: {old!r}")
            head = head.replace(old, f"\n#ifdef {define}\n{new}\n#else\n{old}\n#endif\n")
    return head + "extern \"C\" int jp_conv3x3_wgrad_f32" + tail


def build_anatomy(src_dir: str):
    """Build each variant of `src_dir`'s conv3x3_wgrad.cu into its own
    library under the build directory, all nvcc at once; returns name ->
    (ctypes library, ptxas rows of its bf16 kernels)."""
    import ctypes
    import subprocess

    from chip_smoke import parse_ptxas
    from jperceiver_tpu_torch.ops.cuda import _build
    from torch.utils.cpp_extension import CUDA_HOME

    build = os.path.join(_build.BUILD_DIR, "k4_anatomy")
    os.makedirs(build, exist_ok=True)
    cu = os.path.join(build, "conv3x3_wgrad_anatomy.cu")
    with open(cu, "w") as f:
        f.write(anatomy_copy(open(os.path.join(src_dir, "conv3x3_wgrad.cu")).read()))
    procs = {}
    for name, (defines, *_rest) in ANATOMY.items():
        if name == "no_flush":
            continue
        procs[name] = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
             "-Xcompiler", "-fPIC", "-I", src_dir, *[f"-D{d}" for d in defines],
             *([] if name == "entry" else ["-DK4_KERNEL_ONLY"]),
             "-o", os.path.join(build, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = (P, P, P, P, I, I, I, I, L, L, L, I, L, L, L) + (I,) * 7 + (P,)
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{text}")
        lib = ctypes.CDLL(os.path.join(build, f"{name}.so"))
        lib.jp_conv3x3_wgrad_bf16.argtypes = argtypes
        lib.jp_conv3x3_wgrad_bf16.restype = I
        out[name] = (lib, [{k: r.get(k) for k in ("kernel", "registers", "spill_stores")}
                           for r in parse_ptxas(text) if "wgrad_bf16" in r["kernel"]])
    out["no_flush"] = out["shipped"]
    return out


def k4_anatomy(torch, card: str) -> dict:
    """`--k4-anatomy`: what sets the time of a bf16 K4 block step. At
    ANATOMY_SITES and B = 3, each variant (`ANATOMY`) on the plan's split
    count: its time and microseconds a block step (time over the waves of
    blocks the card holds at once, times the tiles a block sums), and per
    128 pixels; every variant that computes dW is held to the plain version.
    Then the shipped entry (with `sum_splits`) and cuDNN's conv2d_weight at
    every site of the step at B = 1 and 3."""
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (_ceil, _pick_box, _sm_count, _stream,
                                                       _strides, _tma_operand, _wgrad_tma,
                                                       k4_plan)

    variants = build_anatomy(os.path.join(ROOT, "jperceiver_tpu_torch", "ops", "cuda", "csrc"))
    sms = _sm_count(0)
    grad = torch.nn.grad
    g = torch.Generator(device="cuda").manual_seed(6)
    res = {"card": card, "ptxas": {k: v[1] for k, v in variants.items()}, "variants": [],
           "sites": []}

    def operands(bsz, c, o, e, pad):
        hin = e + 2 - 2 * pad
        x = torch.randn(bsz, c, hin, hin, device="cuda", generator=g).bfloat16()
        gy = torch.randn(bsz, o, e, e, device="cuda", generator=g).bfloat16()
        return (x.contiguous(memory_format=torch.channels_last),
                gy.contiguous(memory_format=torch.channels_last), hin)

    for c, o, e, pad in ANATOMY_SITES:
        bsz = 3
        x, gy, hin = operands(bsz, c, o, e, pad)
        xh, gh = _tma_operand(x), _tma_operand(gy)
        p = k4_plan(bsz, hin, hin, c, o, pad, sms)
        ref = conv3x3_wgrad_plain(x, gy, pad)
        scale = ref.abs().max().item()
        part = torch.empty(p.splits, 9, 64 * p.kchunks, p.bn * p.n_tiles, device="cuda")
        dw = torch.empty(o, c, 3, 3, device="cuda")
        for name, (defines, px, no_flush) in ANATOMY.items():
            lib = variants[name][0]
            box_w, box_h = _pick_box(e, e, px)
            tiles = bsz * _ceil(e, box_w) * _ceil(e, box_h)
            per = _ceil(tiles, p.splits)
            splits = _ceil(tiles, per)
            flush = per if no_flush else min(per, p.flush_tiles * 128 // px)
            items_a_block = 1 if name == "one_consumer" else 2
            blocks = _ceil(9 * p.kchunks, items_a_block) * p.n_tiles * splits
            args = (xh.data_ptr(), gh.data_ptr(), part.data_ptr(), dw.data_ptr(), bsz, hin, hin,
                    c, *_strides(xh), o, *_strides(gh), pad, box_w, box_h, p.bn, splits, per,
                    flush)

            def run(lib=lib, args=args):
                _build.check(lib.jp_conv3x3_wgrad_bf16(*args, _stream(xh)), f"K4 anatomy {name}")

            run()
            torch.cuda.synchronize()
            ms = [time_ms(torch, run, reps=10) for _ in range(3)]
            steps = _ceil(blocks, sms) * per
            row = {"card": card, "site": [c, o, e, pad], "batch": bsz, "variant": name,
                   "box": [box_w, box_h], "splits": splits, "tiles_per_split": per,
                   "flush_tiles": flush, "blocks": blocks, "waves": _ceil(blocks, sms), "ms": ms,
                   "us_per_block_step": 1e3 * min(ms) / steps,
                   "us_per_128px": 1e3 * min(ms) / steps * 128 / px}
            if name not in ("tma_only", "resident_only", "one_consumer"):
                # These compute dW: the split partials summed here (the copy
                # runs no `sum_splits`), or dW itself from the whole entry.
                got = dw if name == "entry" else \
                    part[:splits].sum(0)[:, :c, :o].permute(2, 1, 0).reshape(o, c, 3, 3)
                row["max_abs_err_over_scale"] = (got - ref).abs().max().item() / scale
                if not row["max_abs_err_over_scale"] <= 1e-4:
                    raise AssertionError(f"K4 anatomy {name} disagrees: {row}")
            res["variants"].append(row)
            print(json.dumps(row), flush=True)
        del x, gy, xh, gh, part, ref
        torch.cuda.empty_cache()
    for bsz in (1, 3):
        for c, o, e, pad in SITES:
            x, gy, hin = operands(bsz, c, o, e, pad)
            xh = _tma_operand(x)
            p = k4_plan(bsz, hin, hin, c, o, pad, sms)
            dw, ref = conv3x3_wgrad(x, gy, pad), conv3x3_wgrad_plain(x, gy, pad)
            row = {"card": card, "site": [c, o, e, pad], "batch": bsz,
                   "plan": [p.bn, p.splits, p.tiles_per_split],
                   "err_over_scale": ((dw - ref).abs().max() / ref.abs().max()).item(),
                   "k4_ms": time_ms(torch, lambda: _wgrad_tma(xh, gy, pad), reps=10),
                   "cudnn_ms": time_ms(torch, lambda: grad.conv2d_weight(
                       x, (o, c, 3, 3), gy, padding=pad), reps=10)}
            res["sites"].append(row)
            print(json.dumps(row), flush=True)
            del x, gy, xh, dw, ref
    torch.cuda.empty_cache()
    return res


def parent_plan(b: int, hin: int, c: int, o: int, pad: int, sms: int = 132):
    """The parent commit's K4 plan (64-pixel tiles, 64 or 128 wide, splits by
    waves x (tiles a block + 4), the second sum every 4 tiles), as
    (box_w, box_h, bn, splits, tiles_per_split, flush_tiles)."""
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _ceil, _pick_box

    e = hin + 2 * pad - 2
    box_w, box_h = _pick_box(e, e, 64)
    tiles = b * _ceil(e, box_w) * _ceil(e, box_h)
    bn = min((128, 64), key=lambda n: (_ceil(o, n) * n, -n))
    blocks = _ceil(9 * _ceil(c, 64), 2) * _ceil(o, bn)
    splits = min(range(1, max(1, tiles // 16) + 1),
                 key=lambda s: (_ceil(blocks * s, sms) * (_ceil(tiles, s) + 4), s))
    per = _ceil(tiles, splits)
    return box_w, box_h, bn, _ceil(tiles, per), per, min(4, per)


def k4_designs(torch, lib, plib, bsz: int, site, g) -> dict:
    """K4 at one site and batch through its C entry, on the plan's tiles at
    several split counts (each held to the plain version, 1e-4 of the
    largest |dW|, and the same bits twice) beside the plan's choice, cuDNN's
    conv2d_weight and, with `plib`, the parent's K4 on its own plan."""
    from chip_smoke import time_ms
    from jperceiver_tpu_torch.ops.cuda import _build, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import (_ceil, _stream, _strides, _tma_operand,
                                                       k4_plan)

    c, o, e, pad = site
    hin = e + 2 - 2 * pad
    x = torch.randn(bsz, c, hin, hin, device="cuda", generator=g).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(bsz, o, e, e, device="cuda", generator=g).bfloat16()
    gy = gy.contiguous(memory_format=torch.channels_last)
    xh, gh = _tma_operand(x), _tma_operand(gy)
    p = k4_plan(bsz, hin, hin, c, o, pad)
    ref = conv3x3_wgrad_plain(x, gy, pad)
    scale = ref.abs().max().item()
    row = {"site": list(site), "batch": bsz,
           "plan": [p.box_w, p.box_h, p.bn, p.splits, p.tiles_per_split, p.flush_tiles],
           "cudnn_ms": time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
               x, (o, c, 3, 3), gy, padding=pad), reps=10)}
    out = torch.empty(o, c, 3, 3, device="cuda")
    blocks = _ceil(9 * p.kchunks, 2) * p.n_tiles
    wave = max(1, 132 // blocks)
    for splits in sorted({1, 2, 3, 4, 6, 8, 11, 13, 16, 26, wave, 2 * wave, p.splits}):
        if splits > max(1, p.tiles // 4):
            continue
        per = _ceil(p.tiles, splits)
        splits = _ceil(p.tiles, per)
        part = torch.empty(splits, 9, 64 * p.kchunks, p.bn * p.n_tiles, device="cuda")

        def run(splits=splits, per=per, part=part):
            err = lib.jp_conv3x3_wgrad_bf16(
                xh.data_ptr(), gh.data_ptr(), part.data_ptr(), out.data_ptr(), bsz, hin, hin,
                c, *_strides(xh), o, *_strides(gh), pad, p.box_w, p.box_h, p.bn, splits, per,
                min(p.flush_tiles, per), _stream(xh))
            _build.check(err, f"K4 splits {splits}")

        run()
        first = out.clone()
        run()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item() / scale
        same = bool(torch.equal(first.view(torch.int32), out.view(torch.int32)))
        if not (err <= 1e-4 and same):
            raise AssertionError(f"K4 splits {splits} at {site} B {bsz}: err {err}, "
                                 f"repeat {same}")
        row[f"s{splits}_ms"] = time_ms(torch, run, reps=10)
        del part
    if plib is not None:
        box_w, box_h, bn0, splits0, per0, flush0 = parent_plan(bsz, hin, c, o, pad)
        part0 = torch.empty(splits0, 9, 64 * p.kchunks, bn0 * _ceil(o, bn0), device="cuda")

        def run_parent():
            err = plib.jp_conv3x3_wgrad_bf16(
                xh.data_ptr(), gh.data_ptr(), part0.data_ptr(), out.data_ptr(), bsz, hin, hin,
                c, *_strides(xh), o, *_strides(gh), pad, box_w, box_h, bn0, splits0, per0,
                flush0, _stream(xh))
            _build.check(err, "parent conv3x3_wgrad")

        run_parent()
        torch.cuda.synchronize()
        row["parent_err"] = (out - ref).abs().max().item() / scale
        row["parent_ms"] = time_ms(torch, run_parent, reps=10)
        del part0
    row["plan_ms"] = row[f"s{p.splits}_ms"]
    print(json.dumps(row), flush=True)
    return row


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
    if "--k4-anatomy" in sys.argv[1:]:
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True).stdout.strip()
        print(card, flush=True)
        res = k4_anatomy(torch, card)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k4_anatomy.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    if "--k3-tf32" in sys.argv[1:]:
        args = sys.argv[1:]
        rows = k3_tf32_sweep(torch, args[args.index("--parent") + 1] if "--parent" in args
                             else None)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k3_tf32.json"), "w") as f:
            json.dump(rows, f, indent=1)
        return 0
    if "--k4-tf32" in sys.argv[1:]:
        args = sys.argv[1:]
        rows = k4_tf32_sweep(torch, args[args.index("--parent") + 1] if "--parent" in args
                             else None)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k4_tf32.json"), "w") as f:
            json.dump(rows, f, indent=1)
        return 0
    if "--k4-flush" in sys.argv[1:]:
        args = sys.argv[1:]
        rows = k4_flush_sweep(torch, args[args.index("--parent") + 1] if "--parent" in args
                              else None)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k4_flush.json"), "w") as f:
            json.dump(rows, f, indent=1)
        return 0
    lib = _build.library()
    args = sys.argv[1:]
    plib = (build_alone(csrc_of(args[args.index("--parent") + 1]), "conv3x3_wgrad.cu",
                        "parent_k4") if "--parent" in args else None)
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

        row["k4"] = [k4_designs(torch, lib, plib, bsz, (c, o, e, pad), g) for bsz in (1, 3)]
        xh = None
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
