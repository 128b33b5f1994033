#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`jperceiver_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit; build the CUDA kernels from csrc/,
     and log what `nvcc -Xptxas -v` says of each (registers, shared
     memory, spills);
  2. K3 (3x3 conv) against its plain version at every K3 site shape of the
     1024^2 eval forward and training step (the same shapes), bf16 and
     fp32, pad 0 and 1, timed beside F.conv2d, with each site's share of
     its bound (kernel times are device times, `time_ms`; `enqueue_ms` is
     the plain back-to-back time, which at small sites is the host's); and
     every site of the step at phase 9's B=3 in bf16, untimed;
  3. K5 (5x5 max-pool) and its backward kernel against their plain
     versions, bit for bit, at the four CRP shapes with ties, bf16 and fp32,
     timed beside F.max_pool2d and (for scale only: it routes a tie to one
     input) F.max_pool2d's backward; the plain backward's device operations
     counted in a profiler trace; the same for the stem pools' backward
     kernel (maxpool3x3s2_bwd) at the step's four pools and at odd sizes;
     both pools also at phase 9's B=3 in bf16 at the step's shapes;
  4. the eval step at 1024^2, occ 256, both BEV branches, with pose, random
     weights from a seed: fp32 with the kernels on against off (cuDNN and
     the plain pool, TF32 off), bf16 finite and timed both ways, kernel
     launches counted on the main path and in a profiler trace;
  5. streaming inference over 9 frames at 1024^2 in bf16, chunk 4, its
     kernel launches counted and its rotations checked orthonormal;
  6. K1/K2 (reprojection loss forward/backward; K2 routed by K1's code)
     against their plain versions at the training step's shapes, bf16 and
     fp32, B=2 bf16 and F=3, with exact frame ties, K1 fused over the warped
     stack and the automask identity frames (both outputs checked), timed
     beside the plain versions and the ATen path (reprojection_loss + amin,
     forward and autograd backward); in fp32 also on arbitrary pixels and on
     grid_sample outputs, with K1, K2 and their plain versions held to the
     float64 forward and autograd gradient (and their ratios logged); and
     at phase 9's B=3 in fp32, on 8-bit levels and grid_sample outputs;
  7. K3 as the data-grad (pad 2 and 1) and K4 (weight-grad) against their
     plain versions at every K3 site shape of the step, bf16 and fp32,
     timed beside cuDNN's conv2d_input / conv2d_weight, with each site's
     share of its bound; K4 run twice and held bit for bit; and bf16 at
     phase 9's B=3, untimed;
  8. the flagship training step at 1024^2 (bench.py's configuration: road
     branch, B=1, Adam, clip 35), random weights from a seed: fp32 with the
     kernels on against off, both against the step in float64 (losses and
     gradients; the library route's own spread under a rounding-level
     change of the input sets each gradient's bound), bf16 for 20 steps on
     one batch (finite, falling loss, BatchNorm statistics moving),
     frames/s with the kernels on and off in turns, the kernel launches of
     one step from the counters and a profiler trace (K1 once, the CRP
     pools' backward kernel 16 times and the stem pools' 4, no cotangent
     copied), its device operations, busy time, idle share and peak memory;
  9. the kitti_odom_1024 preset trained through the port's entry points
     (Config.fromfile, build_model, get_dataset on simulated scenes,
     DataLoader, Trainer.fit) for 2 epochs of 4 steps at B=3 with remat and
     bf16 compute, with the preset's optimizer (Adam 1e-4, clip 35, the LR
     step at epoch 50): the JAX Trainer's payload keys, one epoch_time an epoch,
     epoch 2's sample order that of set_epoch(1), finite losses, BatchNorm
     statistics moving, the kernel launches of the fit (every K3 site and
     CRP pool of a checkpointed trunk twice a step) from the counters and,
     a step, from a profiler trace of a third epoch, peak memory,
     frames/s (whole fit, and past start-up: the last epoch without its
     wait for the first batch), the loop's wait on the prefetch queue and
     the card's idle share.

Prints the card line, a JSON line describing every kernel, and last the
device line. Full results go to chiprun_out/chip_smoke.json. Exits non-zero
without a CUDA device, outside a checkout of the repo, or when a phase fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
HW, OCC = 1024, 256
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 without tensor
# cores, HBM3 bandwidth.
PEAK_BF16, PEAK_FP32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# Cycles of torch.cuda._sleep per second the host takes to enqueue the
# timed calls: 1.5x the H100's 1.98 GHz boost clock, so the spin outlasts it.
SPIN_CYCLES_PER_S = 3e9
K3_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/conv3x3.cu"
K5_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/maxpool5x5.cu"
K4_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/conv3x3_wgrad.cu"
K12_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/reproj.cu"
K3S2_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/maxpool3x3s2.cu"
# The training step of bench.py:124-137, at the flagship size.
TRAIN_CFG = dict(
    type="static", split="odometry", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
    height=HW, width=HW, occ_map_size=OCC, num_class=2, min_depth=0.1,
    max_depth=100.0, automask=True, disp_norm=True, smoothness_weight=1e-3,
    scale_weight=0.1, static_weight=5.0, dynamic_weight=15.0, loss_type="iou",
    loss_sum=3, loss_weight=20, loss2_weight=20, loss_weightS=20, loss2_weightS=20,
    cgt_label_hw=(375, 1242), optimizer=dict(type="Adam", lr=1e-4, weight_decay=0),
    optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
    lr_config=dict(policy="step", warmup=None, step=[50]))
STEPS_PER_EPOCH = 1000  # the LR milestones' epoch, as bench.py:173 sets it
# Phase 9's batch: the kitti_odom_1024 preset's imgs_per_gpu. Phases 2, 3
# and 7 also hold the kernels at it, in bf16 at the step's site shapes.
FIT_B = 3
# Operations a pixel, channel and frame of the fused reprojection loss (3x3
# separable sums of x, x^2, xy; the SSIM and Charbonnier terms), forward
# and backward (the backward recomputes the forward and gathers 3 fields).
REPROJ_OPS_FWD, REPROJ_OPS_BWD = 40.0, 120.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def enqueue_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over `reps` back-to-back calls between two events:
    the device's time where it is the slower side, else the host's time to
    enqueue a call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls. The calls
    are queued behind a spin kernel that lasts longer than the host takes to
    enqueue them, so the events time the device running them one after
    another, not the host enqueueing them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * enqueue_s) + 1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def parse_ptxas(report: str) -> list[dict]:
    """Per kernel: registers, spill bytes and shared memory from
    `nvcc -Xptxas -v` output."""
    import re

    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["static_smem"] = int(m.group(1))
    return out


def phase_k3(torch, sites, train_sites) -> dict:
    from jperceiver_tpu_torch.ops.cuda import conv3x3_fwd, conv3x3_plain

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"])
                     for s in sites if s["k3"])
    per_step = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"])
                       for s in train_sites if s["k3"])
    rows, max_err = [], 0.0
    tot = Counter()
    ops_t = bytes_t = 0.0
    for (c, o, h, w, site_pad), count in sorted(shapes.items()):
        for dtype in (torch.bfloat16, torch.float32):
            for pad in (0, 1):
                hin, win = h + 2 - 2 * pad, w + 2 - 2 * pad
                x = torch.randn(1, c, hin, win, device="cuda", generator=g)
                x = x.to(dtype).contiguous(memory_format=torch.channels_last)
                wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g)
                      / math.sqrt(9 * c)).to(dtype)
                b = (0.1 * torch.randn(o, device="cuda", generator=g)).to(dtype)
                y = conv3x3_fwd(x, wt, b, pad)
                ref = conv3x3_plain(x, wt, b, pad)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = max(1.0, ref.float().abs().max().item())
                # fp32: the same fp32 sum in another order. bf16: one
                # rounding of that sum to bf16 (2^-8 relative) either way.
                tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
                row = {"c_in": c, "c_out": o, "h": h, "w": w, "pad": pad,
                       "dtype": str(dtype), "max_abs_err": err, "tol": tol}
                if not err <= tol or tuple(y.shape) != (1, o, h, w):
                    raise AssertionError(f"K3 disagrees with its plain version: {row}")
                max_err = max(max_err, err)
                if pad == site_pad:
                    item = x.element_size()
                    n_bytes = (c * hin * win + o * c * 9 + o * h * w) * item + 4 * o
                    n_ops = 2.0 * h * w * o * 9 * c
                    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
                    bnd, by = bound_ms(n_bytes, n_ops, peak)
                    row.update(
                        sites_per_forward=count, sites_per_step=per_step[(c, o, h, w, site_pad)],
                        bound_ms=bnd, bound_by=by,
                        ms=time_ms(torch, lambda: conv3x3_fwd(x, wt, b, pad)),
                        plain_ms=time_ms(torch, lambda: conv3x3_plain(x, wt, b, pad)),
                        library_ms=time_ms(torch, lambda: F.conv2d(x, wt, b, padding=pad)))
                    row.update(bound_share=bnd / row["ms"],
                               library_ratio=row["ms"] / row["library_ms"],
                               enqueue_ms=enqueue_ms(torch, lambda: conv3x3_fwd(x, wt, b, pad)),
                               library_enqueue_ms=enqueue_ms(
                                   torch, lambda: F.conv2d(x, wt, b, padding=pad)))
                    if dtype == torch.bfloat16:
                        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                            tot[k] += count * row[k]
                        ops_t += count * n_ops / peak
                        bytes_t += count * n_bytes / HBM_BYTES_S
                rows.append(row)
                log(f"K3 {row}")
    # Phase 9's fit: every site of the step at B = FIT_B in bf16 (K3's TMA
    # boxes carry the batch coordinate), at the same tolerance, untimed.
    fit_rows = []
    for c, o, h, w, pad in sorted(per_step):
        x = torch.randn(FIT_B, c, h + 2 - 2 * pad, w + 2 - 2 * pad, device="cuda", generator=g)
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)).to(x.dtype)
        b = (0.1 * torch.randn(o, device="cuda", generator=g)).to(x.dtype)
        y = conv3x3_fwd(x, wt, b, pad)
        ref = conv3x3_plain(x, wt, b, pad)
        err = (y.float() - ref.float()).abs().max().item()
        row = {"batch": FIT_B, "c_in": c, "c_out": o, "h": h, "w": w, "pad": pad,
               "dtype": str(x.dtype), "max_abs_err": err,
               "tol": 1e-2 * max(1.0, ref.float().abs().max().item())}
        if not err <= row["tol"] or tuple(y.shape) != (FIT_B, o, h, w):
            raise AssertionError(f"K3 disagrees with its plain version: {row}")
        max_err = max(max_err, err)
        fit_rows.append(row)
        log(f"K3 {row}")
        del x, y, ref
    return {"rows": rows, "fit_batch_rows": fit_rows, "max_abs_err": max_err,
            "per_forward": dict(tot), "bound_by": "bytes" if bytes_t >= ops_t else "operations"}


def phase_k5(torch) -> dict:
    from jperceiver_tpu_torch.ops.cuda import (maxpool5x5_bwd, maxpool5x5_bwd_plain,
                                               maxpool5x5_fwd, maxpool5x5_plain)

    F = torch.nn.functional
    aten = torch.ops.aten
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    tot = Counter()
    # (channels, size, dtype, pools a step): the four CRP shapes in bf16
    # (timed) and fp32, and 13 channels (one channel a vector).
    cases = [(256, s, dt, 4 if dt == torch.bfloat16 else 0)
             for s in (32, 64, 128, 256) for dt in (torch.bfloat16, torch.float32)]
    cases += [(13, 20, torch.bfloat16, 0)]
    # Phase 9's fit: the four CRP shapes at B = FIT_B in bf16, untimed.
    cases = [(c, s, dt, n, 1) for c, s, dt, n in cases]
    cases += [(256, s, torch.bfloat16, 0, FIT_B) for s in (32, 64, 128, 256)]
    for c, s, dtype, per_forward, bsz in cases:
        # Quarter steps through a ReLU: zero plateaus and repeated values.
        x = torch.relu(torch.round(4 * torch.randn(bsz, c, s, s, device="cuda",
                                                   generator=g)) / 4)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        cot = torch.randn(bsz, c, s, s, device="cuda", generator=g).to(dtype)
        cot = cot.contiguous(memory_format=torch.channels_last)
        y = maxpool5x5_fwd(x)
        ref = maxpool5x5_plain(x)
        dx = maxpool5x5_bwd(x, y, cot)
        dref = maxpool5x5_bwd_plain(x, ref, cot)
        torch.cuda.synchronize()
        row = {"batch": bsz, "c": c, "h": s, "w": s, "dtype": str(dtype),
               "bit_exact": bool(torch.equal(y, ref)),
               "max_abs_err": (y.float() - ref.float()).abs().max().item(),
               "bwd_bit_exact": bool(torch.equal(dx, dref)),
               "bwd_max_abs_err": (dx.float() - dref.float()).abs().max().item(),
               "bwd_nonzero": int((dref != 0).sum().item())}
        if not (row["bit_exact"] and row["bwd_bit_exact"]):
            raise AssertionError(f"K5 or its backward differs from its plain version: {row}")
        if per_forward:
            n = x.numel()
            bnd, by = bound_ms(2 * n * x.element_size(), 24.0 * n, PEAK_FP32)
            # The backward reads x, y and g and writes dx; about 30 fp32
            # operations an element (r, two routes of 5 compares and adds).
            bbnd, bby = bound_ms(4 * n * x.element_size(), 30.0 * n, PEAK_FP32)
            _, idx = aten.max_pool2d_with_indices(x, [5, 5], [1, 1], [2, 2])
            row.update(
                pools_per_forward=per_forward, bound_ms=bnd, bound_by=by,
                ms=time_ms(torch, lambda: maxpool5x5_fwd(x)),
                plain_ms=time_ms(torch, lambda: maxpool5x5_plain(x)),
                library_ms=time_ms(torch, lambda: F.max_pool2d(x, 5, 1, 2)),
                bwd_bound_ms=bbnd, bwd_bound_by=bby,
                bwd_ms=time_ms(torch, lambda: maxpool5x5_bwd(x, y, cot)),
                bwd_plain_ms=time_ms(torch, lambda: maxpool5x5_bwd_plain(x, y, cot)),
                # A different function (one input a window gets the
                # cotangent), timed for scale only.
                bwd_max_pool2d_ms=time_ms(torch, lambda: aten.max_pool2d_with_indices_backward(
                    cot, x, [5, 5], [1, 1], [2, 2], [1, 1], False, idx)))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += per_forward * row[k]
                tot["bwd_" + k] += per_forward * row.get("bwd_" + k, 0.0)
            tot["bwd_max_pool2d_ms"] += per_forward * row["bwd_max_pool2d_ms"]
            if s == 256:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    maxpool5x5_bwd_plain(x, y, cot)
                    torch.cuda.synchronize()
                row["plain_bwd_device_ops"] = sum(
                    1 for e in prof.events() if e.device_type.name == "CUDA")
        rows.append(row)
        log(f"K5 {row}")
    per_bwd = {k[4:]: v for k, v in tot.items() if k.startswith("bwd_")}
    per_bwd["library_ms"] = None  # no PyTorch call routes a tie to every maximum
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bwd_max_abs_err": max(r["bwd_max_abs_err"] for r in rows),
            "per_forward": {k: v for k, v in tot.items() if not k.startswith("bwd_")},
            "per_step_bwd": per_bwd, "bound_by": "bytes",
            "plain_bwd_device_ops": next(r["plain_bwd_device_ops"] for r in rows
                                         if "plain_bwd_device_ops" in r)}


def phase_stem_pool(torch) -> dict:
    """`maxpool3x3s2_bwd` (the stem pools' equality-mask backward) against
    its plain version, bit for bit, at the step's four pools (the depth and
    layout encoders at 512^2 x 64, the pose encoder twice at 96 x 320 x 64)
    in bf16 (timed) and fp32, and at 17 x 23 with 64 and 13 channels."""
    from jperceiver_tpu_torch.ops.cuda import (maxpool3x3s2, maxpool3x3s2_bwd,
                                               maxpool3x3s2_bwd_plain)

    aten = torch.ops.aten
    g = torch.Generator(device="cuda").manual_seed(5)
    # (channels, h, w, dtype, pools a step)
    cases = [(64, 512, 512, torch.bfloat16, 2), (64, 96, 320, torch.bfloat16, 2),
             (64, 512, 512, torch.float32, 0), (64, 96, 320, torch.float32, 0),
             (64, 17, 23, torch.bfloat16, 0), (13, 17, 23, torch.bfloat16, 0),
             (13, 17, 23, torch.float32, 0)]
    # Phase 9's fit: the step's two pool shapes at B = FIT_B in bf16, untimed.
    cases = [(c, h, w, dt, n, 1) for c, h, w, dt, n in cases]
    cases += [(64, 512, 512, torch.bfloat16, 0, FIT_B), (64, 96, 320, torch.bfloat16, 0, FIT_B)]
    rows, tot = [], Counter()
    for c, h, w, dtype, per_step, bsz in cases:
        # Quarter steps through a ReLU: zero plateaus and repeated values.
        x = torch.relu(torch.round(4 * torch.randn(bsz, c, h, w, device="cuda", generator=g)) / 4)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        y = maxpool3x3s2(x)
        cot = torch.randn(y.shape, device="cuda", generator=g).to(dtype)
        cot = cot.contiguous(memory_format=torch.channels_last)
        dx = maxpool3x3s2_bwd(x, y, cot)
        dref = maxpool3x3s2_bwd_plain(x, y, cot)
        torch.cuda.synchronize()
        row = {"batch": bsz, "c": c, "h": h, "w": w, "dtype": str(dtype),
               "bit_exact": bool(torch.equal(dx, dref)),
               "max_abs_err": (dx.float() - dref.float()).abs().max().item(),
               "bwd_nonzero": int((dref != 0).sum().item()), "outputs": y.numel()}
        if not row["bit_exact"]:
            raise AssertionError(f"maxpool3x3s2_bwd differs from its plain version: {row}")
        if per_step:
            n, m = x.numel(), y.numel()
            # x and dx, y and g, each once; about 7 operations an input
            # (2.25 windows on average, a compare, a select and an add each).
            bnd, by = bound_ms(2 * (n + m) * x.element_size(), 7.0 * n, PEAK_FP32)
            _, idx = aten.max_pool2d_with_indices(x, [3, 3], [2, 2], [1, 1])
            row.update(
                pools_per_step=per_step, bound_ms=bnd, bound_by=by,
                ms=time_ms(torch, lambda: maxpool3x3s2_bwd(x, y, cot)),
                plain_ms=time_ms(torch, lambda: maxpool3x3s2_bwd_plain(x, y, cot)),
                # A different function (one input a window gets the
                # cotangent), timed for scale only.
                max_pool2d_bwd_ms=time_ms(torch, lambda: aten.max_pool2d_with_indices_backward(
                    cot, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)))
            for k in ("ms", "plain_ms", "bound_ms", "max_pool2d_bwd_ms"):
                tot[k] += per_step * row[k]
            if h == 512:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    maxpool3x3s2_bwd_plain(x, y, cot)
                    torch.cuda.synchronize()
                row["plain_device_ops"] = sum(
                    1 for e in prof.events() if e.device_type.name == "CUDA")
        rows.append(row)
        log(f"stem pool backward {row}")
    per_step = dict(tot, library_ms=None)  # no PyTorch call routes a tie to every maximum
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "per_step": per_step, "bound_by": "bytes",
            "plain_device_ops": next(r["plain_device_ops"] for r in rows
                                     if "plain_device_ops" in r)}


def build_model(torch, dtype, branches="both"):
    from jperceiver_tpu_torch.models import JPerceiver

    torch.manual_seed(0)
    model = JPerceiver(occ_map_size=OCC, dtype=dtype, branches=branches)
    g = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            # std 1/sqrt(fan_in): outputs that vary (the default init gives a
            # near-constant disparity), without the growth through the CRP
            # sums that a ReLU gain gives, which makes fp32 rounding visible.
            torch.nn.init.kaiming_normal_(m.weight, nonlinearity="linear", generator=g)
        elif isinstance(m, torch.nn.BatchNorm2d):  # stats away from the identity
            m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    return model


def cct_probe(torch, model, store: list):
    """Record each CCT's hard-attention argmax and top-2 energy gap."""
    from jperceiver_tpu_torch.models.layout_net import CrossViewTransformer

    def hook(mod, args):
        front_x, cross_x = args[0], args[1]
        q = mod.query_conv(cross_x).flatten(2)
        k = mod.key_conv(front_x).flatten(2).transpose(1, 2)
        e = torch.bmm(k, q).float()
        top2 = e.topk(2, dim=1).values
        store.append((e.argmax(1), top2[:, 0] - top2[:, 1]))

    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, CrossViewTransformer)]


def phase_eval(torch) -> dict:
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_eval_step
    from jperceiver_tpu_torch.models import set_kernels
    from jperceiver_tpu_torch.ops import cuda as kernels

    # On the card once, as a server holds its frame: the steps time the
    # device path, not a 38 MB host-to-device copy of three frames.
    batch = {"color_aug": torch.as_tensor(
        synthetic_batch(1, HW, HW, seed=0)["color_aug"], device="cuda")}
    cfg_on = {"use_pallas_conv": True, "use_pallas_conv_deep": True}
    res = {}

    # fp32, kernels on against off.
    model = build_model(torch, torch.float32)
    step = make_eval_step(model, cfg_on)
    probes_on, probes_off = [], []
    hooks = cct_probe(torch, model, probes_on)
    out_on = step(batch)
    for h in hooks:
        h.remove()
    set_kernels(model, False, False, False)
    hooks = cct_probe(torch, model, probes_off)
    out_off = step(batch)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    flips = []
    for (i_on, gap_on), (i_off, _) in zip(probes_on, probes_off):
        diff = i_on != i_off
        flips.append({"flipped": int(diff.sum()),
                      "min_gap_at_flip": float(gap_on[diff].min()) if diff.any() else None})
    res["cct_argmax"] = flips
    cmp = {}
    for k in sorted(out_on):
        a, b = out_on[k], out_off[k]
        err = (a - b).abs().max().item()
        ref = max(b.abs().max().item(), 1e-12)
        if k.startswith("disp/"):
            tol = 1e-3  # disparity in (0, 1), absolute
        elif k.startswith("cam_T_cam"):
            tol = 1e-4  # pose matrices, absolute
        else:
            tol = 1e-3 * ref  # logits, features, attention: relative to max-abs
        cmp[k] = {"max_abs_err": err, "max_abs": ref, "tol": tol,
                  "shape": list(a.shape)}
        if not (torch.isfinite(a).all() and err <= tol):
            raise AssertionError(f"fp32 eval, kernels on vs off, {k}: {cmp[k]}; "
                                 f"CCT argmax flips {flips}")
    res["fp32_on_vs_off"] = cmp
    log(f"fp32 on vs off: {json.dumps(cmp)}\nCCT argmax: {flips}")
    del model, step, out_on, out_off

    # bf16: finite, and ms/frame with the kernels on and off, in turns.
    model = build_model(torch, torch.bfloat16)
    step = make_eval_step(model, cfg_on)

    def step_ms(on: bool, steps: int = 25) -> list[float]:
        """Latency of single-frame requests: host clock, synchronized."""
        set_kernels(model, on, on, on)
        for _ in range(3):
            step(batch)
        out = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    samples = {"on": [], "off": []}
    turns = []
    for on in (True, False, False, True, True, False, False, True):
        v = step_ms(on)
        samples["on" if on else "off"] += v
        turns.append(("on" if on else "off", sorted(v)[len(v) // 2]))
    times = {"turn_medians": turns}
    for k, v in samples.items():
        v = sorted(v)  # 100 samples: p90 has 10 beyond it
        times[k] = {"n": len(v), "median": v[len(v) // 2],
                    "p90": v[int(0.9 * len(v))], "min": v[0]}
    res["bf16_ms_per_frame"] = times

    # The main path: counts set to 0 just before, read just after.
    set_kernels(model, True, True, True)
    kernels.reset_launch_counts()
    out = step(batch)
    torch.cuda.synchronize()
    res["launches"] = kernels.launch_counts()
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"bf16 eval output {k} is not finite")
    res["bf16_keys"] = {k: list(v.shape) for k, v in out.items()}

    # The same step under the profiler: kernel symbols by name.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = Counter(e.name for e in dev)
    busy = Counter()
    for e in dev:
        busy[e.name] += e.time_range.elapsed_us() / 1e3
    span_ms = (max(e.time_range.end for e in dev)
               - min(e.time_range.start for e in dev)) / 1e3 if dev else 0.0
    busy_ms = sum(busy.values())
    res["profiler"] = {
        "k3": sum(n for k, n in names.items() if "conv3x3_bf16" in k),
        "k5": sum(n for k, n in names.items() if "maxpool5x5_nhwc" in k),
        "device_events": sum(names.values()),
        "device_busy_ms": busy_ms,
        "device_span_ms": span_ms,
        "idle_share": 1 - busy_ms / span_ms if span_ms else None,
        "top_kernels_ms": dict(busy.most_common(8)),
    }
    log(f"bf16 ms/frame {times}; launches {res['launches']}; "
        f"profiler {res['profiler']}")
    return res


def phase_stream(torch, n_k3: int) -> dict:
    from jperceiver_tpu_torch.engine import make_streaming_fn
    from jperceiver_tpu_torch.ops import cuda as kernels

    model = build_model(torch, torch.bfloat16)
    run = make_streaming_fn(model, chunk=4)
    g = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.rand(9, 3, HW, HW, device="cuda", generator=g)
    run(frames)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ys = run(frames)
    torch.cuda.synchronize()
    seconds = [time.perf_counter() - t0]
    launches = kernels.launch_counts()
    for _ in range(4):
        t0 = time.perf_counter()
        run(frames)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    # Two chunks of 4 frames, each one batched eval forward; the pose net
    # has no K3 site.
    if launches != {k: 0 for k in launches} | {"conv3x3": 2 * n_k3, "maxpool5x5": 2 * 16}:
        raise AssertionError(f"streaming launches {launches}")
    eye = torch.eye(3, device="cuda")
    orth = {}
    for k in ("cam_T_cam", "global_pose"):
        r = ys[k].float()[:, :3, :3]
        orth[k] = (r @ r.transpose(1, 2) - eye).abs().max().item()
        if not (torch.isfinite(ys[k]).all() and orth[k] <= 2e-2):
            raise AssertionError(f"streaming {k}: |R R^T - I| = {orth[k]}")
    shapes = {k: list(v.shape) for k, v in ys.items()}
    if shapes["disp"] != [8, 1, HW // 2, HW // 2] or shapes["global_pose"] != [8, 4, 4]:
        raise AssertionError(f"streaming output shapes {shapes}")
    res = {"frames_per_s": 8 / sorted(seconds)[len(seconds) // 2],
           "seconds": seconds, "orthonormal_err": orth,
           "shapes": shapes, "launches": launches}
    log(f"streaming {res}")
    return res


def _levels(torch, g, shape):
    """Uniform image levels k/256 in [0, 1]: 8-bit pixels, exact in bf16 and
    fp32, so the SSIM window sums are exact in both versions."""
    return torch.round(256 * torch.rand(shape, device="cuda", generator=g)) / 256


def _tie_preds(torch, g, shape, dtype, levels=True):
    """Random preds whose frame 1 copies frame 0 over the left half of the
    image and frame 2 over the top half: exact frame ties there."""
    p = _levels(torch, g, shape) if levels else torch.rand(shape, device="cuda", generator=g)
    if shape[2] > 1:
        p[:, :, 1, ..., : shape[-1] // 2] = p[:, :, 0, ..., : shape[-1] // 2]
    if shape[2] > 2:
        p[:, :, 2, :, : shape[-2] // 2] = p[:, :, 0, :, : shape[-2] // 2]
    return p.to(dtype)


def _near_ties(torch, rl, gap_max=1e-5):
    """Pixels (S, B, H, W) where two frames' losses differ by less than
    gap_max but are not equal (fp32 may route them either way), and the
    count of exactly tied frame pairs."""
    amb = torch.zeros_like(rl[:, :, 0], dtype=torch.bool)
    ties = 0
    for f in range(rl.shape[2]):
        for f2 in range(f + 1, rl.shape[2]):
            gap = (rl[:, :, f] - rl[:, :, f2]).abs()
            amb |= (gap > 0) & (gap < gap_max)
            ties += int((gap == 0).sum().item())
    return amb, ties


def _warped_preds(torch, g, shape):
    """fp32 grid_sample outputs (border padding) of random frames at random
    affine warps that push part of each frame out of view: the kind of
    operand the training step gives K1/K2, with clamped flat regions."""
    s_, b_, f_, c_, h, w = shape
    frames = torch.rand((b_ * f_, c_, h, w), device="cuda", generator=g)
    theta = torch.eye(2, 3, device="cuda").repeat(s_ * b_ * f_, 1, 1)
    theta[:, :, :2] += 0.15 * torch.randn((s_ * b_ * f_, 2, 2), device="cuda", generator=g)
    theta[:, :, 2] = 0.2 * torch.randn((s_ * b_ * f_, 2), device="cuda", generator=g)
    grid = torch.nn.functional.affine_grid(theta, (s_ * b_ * f_, c_, h, w), align_corners=True)
    src = frames.repeat(s_, 1, 1, 1)
    out = torch.nn.functional.grid_sample(src, grid, padding_mode="border", align_corners=True)
    return out.reshape(s_, b_, f_, c_, h, w).contiguous()


def _k2_f64_witness(torch, preds, targ, cot, d, dref) -> dict:
    """Distances of K2 (d) and its plain version (dref) to the float64
    autograd gradient at the same fp32 operands, outside +-2 pixels of
    frame-mins decided by less than 1e-5 (there fp32 may route a pixel to the
    other frame); exact ties stay in."""
    from jperceiver_tpu_torch.ops.photometric import reprojection_loss

    F = torch.nn.functional
    s_, b_, _, _, h, w = preds.shape
    p = preds.double().requires_grad_()
    with torch.enable_grad():
        rl = reprojection_loss(p, targ.double()[:, None])[:, :, :, 0]
        best = rl[:, :, 0]
        for f in range(1, rl.shape[2]):
            best = torch.minimum(best, rl[:, :, f])
        (g64,) = torch.autograd.grad(best, p, cot.double())
    amb, _ = _near_ties(torch, rl.detach())
    amb = amb.float().reshape(s_ * b_, 1, h, w)
    keep = (F.max_pool2d(amb, 5, 1, 2) == 0).reshape(s_, b_, 1, 1, h, w)
    ek = (d.double() - g64) * keep
    ep = (dref.double() - g64) * keep
    out = {"k2_err_f64": ek.abs().max().item(), "plain_err_f64": ep.abs().max().item(),
           "k2_rms_f64": ek.pow(2).mean().sqrt().item(),
           "plain_rms_f64": ep.pow(2).mean().sqrt().item(),
           "grad_f64_max": g64.abs().max().item(), "f64_pixels_masked": int((~keep).sum().item())}
    out["k2_over_plain_max"] = out["k2_err_f64"] / out["plain_err_f64"]
    out["k2_over_plain_rms"] = out["k2_rms_f64"] / out["plain_rms_f64"]
    del p, rl, best, g64, ek, ep
    return out


def _k1_f64_witness(torch, preds, ident, targ, out, ident_l, ref, ref_ident) -> dict:
    """Largest distances of K1's two outputs and of its plain version's to
    the float64 forward at the same fp32 operands."""
    from jperceiver_tpu_torch.ops.cuda import reproj_min_plain

    t64 = targ.double()
    w64 = reproj_min_plain(preds.double(), t64)
    i64 = reproj_min_plain(ident.double()[:, :, None], t64)
    res = {"k1_warp_err_f64": (out.double() - w64).abs().max().item(),
           "k1_plain_warp_err_f64": (ref.double() - w64).abs().max().item(),
           "k1_ident_err_f64": (ident_l.double() - i64).abs().max().item(),
           "k1_plain_ident_err_f64": (ref_ident.double() - i64).abs().max().item()}
    res["k1_err_f64"] = max(res["k1_warp_err_f64"], res["k1_ident_err_f64"])
    res["k1_plain_err_f64"] = max(res["k1_plain_warp_err_f64"], res["k1_plain_ident_err_f64"])
    res["k1_over_plain_max"] = res["k1_err_f64"] / res["k1_plain_err_f64"]
    del w64, i64
    return res


def phase_reproj(torch) -> dict:
    from jperceiver_tpu_torch.ops.cuda.reproj import (_bwd, _fwd, _reproj_bwd_plain,
                                                      reproj_min_plain)
    from jperceiver_tpu_torch.ops.photometric import reprojection_loss

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    # (shape of the warped stack, dtype, operands, timed): every case runs
    # the fused K1 -- the warped stack and F identity frames against one
    # target, in one launch -- and K2 on its routing code. The flagship's
    # operands (B=1, bf16) are timed; B=2 in bf16, three frames in bf16 and
    # fp32, and in fp32 8-bit levels, arbitrary fp32 pixels and grid_sample
    # outputs. On 8-bit levels the window sums are exact in both versions;
    # on the other fp32 operands both versions round them, and each is held
    # to float64 as well as to the other.
    cases = [((4, 1, 2, 3, HW, HW), bf16, "levels", True),
             ((4, 2, 2, 3, HW, HW), bf16, "levels", False),
             ((4, 1, 3, 3, HW, HW), bf16, "levels", False),
             ((4, 1, 3, 3, HW, HW), f32, "levels", False),
             ((4, 1, 2, 3, HW, HW), f32, "levels", False),
             ((4, 1, 2, 3, HW, HW), f32, "arbitrary", False),
             ((4, 1, 2, 3, HW, HW), f32, "grid_sample", False),
             # Phase 9's operands: the preset's B=3, fp32 ("auto" is bf16 at
             # B=1 only).
             ((4, 3, 2, 3, HW, HW), f32, "levels", False),
             ((4, 3, 2, 3, HW, HW), f32, "grid_sample", False)]
    rows, tot, f64_ratios, k1_f64 = [], Counter(), {}, {}
    err_f = err_b = 0.0
    for shape, dtype, operands, timed in cases:
        s_, b_, f_ = shape[:3]
        ishape = (f_, b_, 3, HW, HW)
        if operands == "grid_sample":
            preds = _warped_preds(torch, g, shape)
            ident = torch.rand(ishape, device="cuda", generator=g)
            targ = torch.rand((b_, 3, HW, HW), device="cuda", generator=g)
        elif operands == "levels":
            preds = _tie_preds(torch, g, shape, dtype)
            ident = _levels(torch, g, ishape).to(dtype)
            targ = _levels(torch, g, (b_, 3, HW, HW)).to(dtype)
        else:
            preds = _tie_preds(torch, g, shape, dtype, levels=False)
            ident = torch.rand(ishape, device="cuda", generator=g)
            targ = torch.rand((b_, 3, HW, HW), device="cuda", generator=g)
        cot = torch.randn((s_, b_, HW, HW), device="cuda", generator=g)
        out, code, ident_l = _fwd(preds, targ, True, ident)
        ref, ref_ident = reproj_min_plain(preds, targ), reproj_min_plain(ident[:, :, None], targ)
        torch.cuda.synchronize()
        ef = max((out - ref).abs().max().item(), (ident_l - ref_ident).abs().max().item())
        # Both sum the same fp32 statistics in another order; values are O(1).
        row = {"shape": list(shape), "ident_shape": list(ishape), "dtype": str(dtype),
               "operands": operands, "fwd_max_abs_err": ef, "fwd_tol": 2e-5}
        if not ef <= 2e-5:
            raise AssertionError(f"K1 disagrees with its plain version: {row}")
        err_f = max(err_f, ef)
        if dtype == f32 and operands != "levels":
            # K1 no farther from the float64 forward than 2x its plain version.
            row.update(_k1_f64_witness(torch, preds, ident, targ, out, ident_l, ref, ref_ident))
            k1_f64[f"{operands}, B={b_}"] = {k: row[k] for k in (
                "k1_err_f64", "k1_plain_err_f64", "k1_over_plain_max")}
            if not row["k1_err_f64"] <= 2 * row["k1_plain_err_f64"]:
                raise AssertionError(f"K1 farther from float64 than its plain version: {row}")
        d, dref = _bwd(preds, targ, cot, code), _reproj_bwd_plain(preds, targ, cot)
        # A frame-min decided by less than the two versions' rounding may
        # route a pixel's cotangent to the other frame; the gradient of a
        # pixel reads the routing within 2 pixels of it. Exact ties (the
        # copied halves) are ties in both and stay in the comparison.
        rl = reprojection_loss(preds.float(), targ.float()[:, None])[:, :, :, 0]
        amb, ties = _near_ties(torch, rl)
        amb = amb.float().reshape(s_ * b_, 1, HW, HW)
        keep = (F.max_pool2d(amb, 5, 1, 2) == 0).reshape(s_, b_, 1, 1, HW, HW)
        diff = ((d.float() - dref.float()).abs() * keep).max().item()
        scale = dref.float().abs().max().item()
        tol = (1e-4 if dtype == f32 else 1e-2) * scale
        row.update(bwd_max_abs_err=diff, bwd_tol=tol, exact_tie_pixels=ties,
                   near_tie_pixels_masked=int(amb.sum().item()),
                   pixels_masked=int((~keep).sum().item()))
        del rl, amb, keep
        if dtype == f32:
            # K2 no farther from float64 than its plain version: its largest
            # distance within 2x the plain version's, its RMS distance
            # within 1.25x.
            row.update(_k2_f64_witness(torch, preds, targ, cot, d, dref))
            f64_ratios[f"{operands}, B={b_}, F={f_}"] = {
                k: row[k] for k in ("k2_over_plain_max", "k2_over_plain_rms")}
            if not (row["k2_err_f64"] <= 2 * row["plain_err_f64"]
                    and row["k2_rms_f64"] <= 1.25 * row["plain_rms_f64"]):
                raise AssertionError(f"K2 farther from float64 than its plain version: {row}")
        if operands == "levels" and not diff <= tol:
            raise AssertionError(f"K2 disagrees with its plain version: {row}")
        err_b = max(err_b, diff) if operands == "levels" else err_b
        del d, dref
        if timed:
            # One step's K1: the warped stack with its routing code and the
            # identity frames, one launch.
            n_in = sum(t.numel() * t.element_size() for t in (preds, ident, targ))
            n_out = (4 + 2) * s_ * b_ * HW * HW + 4 * f_ * b_ * HW * HW
            bnd, by = bound_ms(n_in + n_out, REPROJ_OPS_FWD * (preds.numel() + ident.numel()),
                               PEAK_FP32)

            def plain_fwd():
                reproj_min_plain(preds, targ)
                reproj_min_plain(ident[:, :, None], targ)

            def lib_fwd():
                reprojection_loss(preds, targ[:, None]).amin(2)[:, :, 0]
                reprojection_loss(ident[:, :, None], targ[:, None]).amin(2)[:, :, 0]

            row.update(bound_ms=bnd, bound_by=by,
                       ms=time_ms(torch, lambda: _fwd(preds, targ, True, ident), reps=10),
                       plain_ms=time_ms(torch, plain_fwd, reps=5),
                       library_ms=time_ms(torch, lib_fwd, reps=5))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot["k1_" + k] = row[k]
            pg = preds.detach().requires_grad_()
            n_in = preds.numel() * preds.element_size() + targ.numel() * targ.element_size()

            def lib_fwd_bwd():
                reprojection_loss(pg, targ[:, None]).amin(2)[:, :, 0].backward(cot)

            def lib_warp():
                reprojection_loss(preds, targ[:, None]).amin(2)[:, :, 0]

            bnd, by = bound_ms(2 * n_in + 4 * s_ * b_ * HW * HW,
                               REPROJ_OPS_BWD * preds.numel(), PEAK_FP32)
            row.update(bwd_bound_ms=bnd, bwd_bound_by=by,
                       bwd_ms=time_ms(torch, lambda: _bwd(preds, targ, cot, code), reps=10),
                       bwd_plain_ms=time_ms(
                           torch, lambda: _reproj_bwd_plain(preds, targ, cot), reps=5),
                       bwd_library_ms=time_ms(torch, lib_fwd_bwd, reps=5)
                       - time_ms(torch, lib_warp, reps=5))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot["k2_" + k] = row["bwd_" + k]
            tot["bound_by_fwd"], tot["bound_by_bwd"] = row["bound_by"], by
        rows.append(row)
        log(f"K1/K2 {row}")
        del preds, ident, targ, cot, out, ref, ref_ident, ident_l, code
        torch.cuda.empty_cache()
    log(f"K1 / plain distance to float64 (largest): {k1_f64}")
    log(f"K2 / plain distance to float64 (max, RMS): {f64_ratios}")
    return {"rows": rows, "k1_max_abs_err": err_f, "k2_max_abs_err": err_b,
            "per_step": dict(tot), "k1_f64": k1_f64, "k2_f64_ratios": f64_ratios}


def phase_conv_bwd(torch, sites) -> dict:
    """K3 as the data-grad and K4 at every K3 site shape of the step."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv, _tma_operand, _wgrad_bf16

    grad = torch.nn.grad
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"]) for s in sites if s["k3"])
    rows, tot = [], Counter()
    err_d = err_w = 0.0
    ops_t = bytes_t = 0.0
    # bf16 and fp32 at B=1 (timed in bf16), then bf16 at phase 9's B = FIT_B
    # (K4's pixel split depends on B*H*W), untimed.
    cases = [(shape, dtype, 1) for shape in sorted(shapes)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, torch.bfloat16, FIT_B) for shape in sorted(shapes)]
    for (c, o, h, w, pad), dtype, bsz in cases:
        count = shapes[(c, o, h, w, pad)]
        hin, win = h + 2 - 2 * pad, w + 2 - 2 * pad
        x = torch.randn(bsz, c, hin, win, device="cuda", generator=g).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)).to(dtype)
        gy = torch.randn(bsz, o, h, w, device="cuda", generator=g).to(dtype)
        gy = gy.contiguous(memory_format=torch.channels_last)
        wflip = wt.flip(2, 3).transpose(0, 1)
        dx = _conv(gy, wflip, None, 2 - pad, "conv3x3_dgrad")
        dx_ref = conv3x3_plain(gy, wflip, None, 2 - pad)
        dw = conv3x3_wgrad(x, gy, pad)
        dw_again = conv3x3_wgrad(x, gy, pad)
        dw_ref = conv3x3_wgrad_plain(x, gy, pad)
        torch.cuda.synchronize()
        if not torch.equal(dw.view(torch.int32), dw_again.view(torch.int32)):
            raise AssertionError(f"K4 differs between two runs at {(c, o, h, w, pad, dtype)}")
        ed = (dx.float() - dx_ref.float()).abs().max().item()
        sd = max(1.0, dx_ref.float().abs().max().item())
        ew = (dw - dw_ref).abs().max().item()
        sw = dw_ref.abs().max().item()
        # dgrad: as K3's forward (fp32 order; one bf16 rounding). K4: fp32
        # sums of 9C x O over M pixels in another order, both dtypes.
        row = {"batch": bsz, "c_in": c, "c_out": o, "h": h, "w": w, "pad": pad,
               "dgrad_pad": 2 - pad,
               "dtype": str(dtype), "dgrad_max_abs_err": ed,
               "dgrad_tol": (1e-4 if dtype == torch.float32 else 1e-2) * sd,
               "wgrad_max_abs_err": ew, "wgrad_tol": 1e-4 * sw,
               "dx_shape": list(dx.shape)}
        if not (ed <= row["dgrad_tol"] and tuple(dx.shape) == tuple(x.shape)):
            raise AssertionError(f"K3 data-grad disagrees with its plain version: {row}")
        if not (ew <= row["wgrad_tol"] and tuple(dw.shape) == (o, c, 3, 3)):
            raise AssertionError(f"K4 disagrees with its plain version: {row}")
        err_d, err_w = max(err_d, ed), max(err_w, ew)
        if bsz != 1:
            # K4's and the plain version's distances to float64 (cuDNN in
            # fp64 on the same bf16 inputs): which of the two moves with B.
            dw64 = grad.conv2d_weight(x.double(), wt.shape, gy.double(), padding=pad)
            row.update(wgrad_err_f64=(dw.double() - dw64).abs().max().item(),
                       wgrad_plain_err_f64=(dw_ref.double() - dw64).abs().max().item())
            del dw64
            rows.append(row)
            log(f"K3-dgrad/K4 {row}")
            continue
        if dtype == torch.float32:
            # Distance to float64 (cuDNN in fp64) of the kernels and of
            # cuDNN in fp32, at the same inputs.
            x64, w64, g64 = x.double(), wt.double(), gy.double()
            dx64 = grad.conv2d_input(x.shape, w64, g64, padding=pad)
            dw64 = grad.conv2d_weight(x64, wt.shape, g64, padding=pad)
            row.update(
                dgrad_err_f64=(dx.double() - dx64).abs().max().item(),
                dgrad_library_err_f64=(grad.conv2d_input(x.shape, wt, gy, padding=pad)
                                       .double() - dx64).abs().max().item(),
                wgrad_err_f64=(dw.double() - dw64).abs().max().item(),
                wgrad_library_err_f64=(grad.conv2d_weight(x, wt.shape, gy, padding=pad)
                                       .double() - dw64).abs().max().item())
            del x64, w64, g64, dx64, dw64
        if dtype == torch.bfloat16:
            item = x.element_size()
            n_ops = 2.0 * h * w * o * 9 * c
            bd, byd = bound_ms((o * h * w + o * c * 9 + c * hin * win) * item, n_ops, PEAK_BF16)
            bw, byw = bound_ms((c * hin * win + o * h * w) * item + 4 * o * c * 9, n_ops,
                               PEAK_BF16)
            # In the step K4 reads the operand the forward made for K3 (a
            # copy only for the 513-channel concat, timed in phase 2).
            xh = _tma_operand(x)
            row.update(
                sites_per_step=count, dgrad_bound_ms=bd, wgrad_bound_ms=bw,
                dgrad_ms=time_ms(torch, lambda: _conv(gy, wflip, None, 2 - pad, "conv3x3_dgrad"), reps=10),
                dgrad_plain_ms=time_ms(torch, lambda: conv3x3_plain(gy, wflip, None, 2 - pad), reps=5),
                dgrad_library_ms=time_ms(torch, lambda: grad.conv2d_input(x.shape, wt, gy, padding=pad), reps=10),
                wgrad_ms=time_ms(torch, lambda: _wgrad_bf16(xh, gy, pad), reps=10),
                wgrad_plain_ms=time_ms(torch, lambda: conv3x3_wgrad_plain(x, gy, pad), reps=5),
                wgrad_library_ms=time_ms(torch, lambda: grad.conv2d_weight(x, wt.shape, gy, padding=pad), reps=10))
            for k in ("dgrad_", "wgrad_"):
                row[k + "bound_share"] = row[k + "bound_ms"] / row[k + "ms"]
                row[k + "library_ratio"] = row[k + "ms"] / row[k + "library_ms"]
            row.update(
                dgrad_enqueue_ms=enqueue_ms(torch, lambda: _conv(gy, wflip, None, 2 - pad,
                                                             "conv3x3_dgrad")),
                wgrad_enqueue_ms=enqueue_ms(torch, lambda: _wgrad_bf16(xh, gy, pad)))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot["dgrad_" + k] += count * row["dgrad_" + k]
                tot["wgrad_" + k] += count * row["wgrad_" + k]
            ops_t += count * n_ops / PEAK_BF16
            bytes_t += count * (c * hin * win + o * h * w) * item / HBM_BYTES_S
        rows.append(row)
        log(f"K3-dgrad/K4 {row}")
    return {"rows": rows, "dgrad_max_abs_err": err_d, "wgrad_max_abs_err": err_w,
            "per_step": dict(tot), "bound_by": "bytes" if bytes_t >= ops_t else "operations"}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def phase_train(torch) -> dict:
    import copy

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to
    from jperceiver_tpu_torch.models import set_kernels
    from jperceiver_tpu_torch.ops import cuda as kernels

    batch = batch_to(synthetic_batch(1, HW, HW, OCC, seed=0), "cuda")
    res = {}

    # fp32, kernels on (K1/K2, K3/K4, K5) against off (the unfused
    # photometric path, cuDNN, the plain pool), from the same weights, batch
    # and generator seed; fp32 operands for the reprojection kernels. Both
    # are held to the same step in float64 (kernels off; the frames and the
    # photometric loss in float64 too). Some gradients pass through the CRP
    # max-pools, whose backward routes to the maxima a forward found, so a
    # rounding-level change upstream moves them by whatever the routing flips
    # carry. The library route's own spread under such a change -- the same
    # route with the model input scaled by 1 + k 2^-22, k = 1, 2 -- measures
    # that per parameter. Each gradient of the kernels' route must be within
    # 3 x max(the library route's distance to float64, that spread) plus
    # 1e-3 of its own scale.
    model = build_model(torch, torch.float32, "road")
    init = copy.deepcopy(model.state_dict())
    runs = {}
    for name, dtype, on, nudge in (("on", torch.float32, True, 0), ("off", torch.float32, False, 0),
                                   ("off~1", torch.float32, False, 1),
                                   ("off~2", torch.float32, False, 2),
                                   ("f64", torch.float64, False, 0)):
        run_batch = dict(batch, color_aug=batch["color_aug"] * (1 + nudge * 2.0 ** -22))
        if dtype == torch.float64:
            model = build_model(torch, dtype, "road").double()
            run_batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        model.load_state_dict(init)
        step = make_train_step(model, dict(TRAIN_CFG, use_pallas_reproj=on,
                                           pallas_reproj_bf16=False), seed=0,
                               steps_per_epoch=STEPS_PER_EPOCH)
        set_kernels(model, on, on, on, stem_pool=on)
        probes = []
        hooks = cct_probe(torch, model, probes)
        m = step(run_batch)
        for h in hooks:
            h.remove()
        runs[name] = ({k: float(v) for k, v in m.items()}, _grads(model), probes)
        del step
    (m_on, g_on, p_on), (m_off, g_off, p_off), (m64, g64, _) = (runs[k] for k in ("on", "off", "f64"))
    flips = [int((a[0] != b[0]).sum()) for a, b in zip(p_on, p_off)]
    loss_cmp = {k: {"on": m_on[k], "off": m_off[k], "f64": m64[k]} for k in m64}
    rows = []
    for n, ref in g64.items():
        e_on = (g_on[n].double() - ref).abs().max().item()
        e_off = (g_off[n].double() - ref).abs().max().item()
        spread = max((runs[k][1][n] - g_off[n]).abs().max().item() for k in ("off~1", "off~2"))
        scale = ref.abs().max().item()
        rows.append([e_on / (3 * max(e_off, spread) + 1e-3 * scale), n, e_on, e_off, spread, scale])
    rows.sort(reverse=True)
    res["fp32_on_vs_off"] = {"losses": loss_cmp, "cct_argmax_flips": flips,
                             "largest_grad_f64": max(r[5] for r in rows),
                             "worst_grads": [list(r) for r in rows[:8]],
                             "grads_over_own_1e-3": sum(r[2] > 1e-3 * r[5] for r in rows),
                             "grads_over_own_1e-3_off": sum(r[3] > 1e-3 * r[5] for r in rows),
                             "n_grads": len(rows),
                             "grad_err_on_max": max(r[2] for r in rows),
                             "grad_err_off_max": max(r[3] for r in rows)}
    log(f"train fp32 on vs off: {json.dumps(res['fp32_on_vs_off'])}")
    for k, v in loss_cmp.items():
        # The kernels' route within 1e-4 of float64 or no farther than the
        # library's (grad_norm is a gradient quantity).
        d_on, d_off = abs(v["on"] - v["f64"]), abs(v["off"] - v["f64"])
        if not (math.isfinite(v["on"]) and d_on <= 1e-4 * max(1.0, abs(v["f64"])) + 3 * d_off):
            raise AssertionError(f"fp32 train step, kernels on vs off, {k}: {v}")
    if rows[0][0] > 1:
        raise AssertionError(f"fp32 train step gradients, kernels on farther from float64 "
                             f"than the library route and its spread: {rows[:4]}")
    del model, init, runs, g_on, g_off, g64
    torch.cuda.empty_cache()

    # bf16: the flagship step. 20 steps on one batch.
    model = build_model(torch, torch.bfloat16, "road")
    bn = model.DepthEncoder.encoder.bn1
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())
    step = make_train_step(model, TRAIN_CFG, seed=1, steps_per_epoch=STEPS_PER_EPOCH)
    losses = []
    for _ in range(20):
        losses.append(float(step(batch)["loss"]))
    moved = max((bn.running_mean.cpu() - stats0[0]).abs().max().item(),
                (bn.running_var.cpu() - stats0[1]).abs().max().item())
    res["bf16_losses"] = losses
    res["bn_running_stat_change"] = moved
    log(f"train bf16 losses {losses}; BN stats moved by {moved}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0] and moved > 0):
        raise AssertionError(f"bf16 training: losses {losses}, BN change {moved}")

    # Frames/s, kernels on and off in turns (host clock, synchronized; B=1).
    step_off = make_train_step(model, dict(TRAIN_CFG, use_pallas_reproj=False), seed=2,
                               steps_per_epoch=STEPS_PER_EPOCH)
    step_on = make_train_step(model, TRAIN_CFG, seed=3, steps_per_epoch=STEPS_PER_EPOCH)

    def turn(on: bool, n: int = 5) -> list[float]:
        set_kernels(model, on, on, on, stem_pool=on)
        fn = step_on if on else step_off
        fn(batch)
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    samples = {"on": [], "off": []}
    turns = []
    for on in (True, False, False, True, True, False, False, True):
        v = turn(on)
        samples["on" if on else "off"] += v
        turns.append(("on" if on else "off", 1.0 / sorted(v)[len(v) // 2]))
    fps = {"turn_frames_per_s": turns}
    for k, v in samples.items():
        v = sorted(v)
        fps[k] = {"n": len(v), "median_frames_per_s": 1.0 / v[len(v) // 2],
                  "median_ms": 1e3 * v[len(v) // 2], "min_ms": 1e3 * v[0], "max_ms": 1e3 * v[-1]}
    res["bf16_frames_per_s"] = fps
    log(f"train bf16 frames/s {fps}")

    # The main path: counts set to 0 just before one step, read just after.
    set_kernels(model, True, True, True, stem_pool=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m = step_on(batch)
    torch.cuda.synchronize()
    res["launches"] = kernels.launch_counts()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["metrics"] = {k: float(v) for k, v in m.items()}

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_on(batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = Counter(e.name for e in dev)
    busy = Counter()
    for e in dev:
        busy[e.name] += e.time_range.elapsed_us() / 1e3
    span_ms = (max(e.time_range.end for e in dev)
               - min(e.time_range.start for e in dev)) / 1e3 if dev else 0.0
    busy_ms = sum(busy.values())

    def count(sub):
        return sum(n for k, n in names.items() if sub in k)

    def kernel_ms(sub):
        return sum(v for k, v in busy.items() if sub in k)

    top = dict(busy.most_common(12))
    res["profiler"] = {
        "k1": count("reproj_fwd"), "k2": count("reproj_bwd"), "k3": count("conv3x3_bf16"),
        "k4": count("wgrad_bf16"), "k5": count("maxpool5x5_nhwc"),
        "k5_bwd": count("maxpool5x5_bwd_nhwc"), "stem_pool_bwd": count("maxpool3x3s2_bwd"),
        "kernel_busy_ms": {"k1": kernel_ms("reproj_fwd"), "k2": kernel_ms("reproj_bwd"),
                           "k3": kernel_ms("conv3x3_bf16"), "k4": kernel_ms("wgrad_bf16"),
                           "k4_sum_splits": kernel_ms("sum_splits"),
                           "k5": kernel_ms("maxpool5x5_nhwc"),
                           "k5_bwd": kernel_ms("maxpool5x5_bwd_nhwc"),
                           "stem_pool_bwd": kernel_ms("maxpool3x3s2_bwd")},
        # The bf16 equality masks and selects of the plain pool backwards.
        "bf16_eq_ms": kernel_ms("CompareEqFunctor<c10::BFloat16"),
        "where_ms": kernel_ms("where_kernel_impl"),
        "where_or_eq_in_top12": any("where_kernel_impl" in k or "CompareEqFunctor" in k
                                    for k in top),
        "device_events": sum(names.values()), "device_busy_ms": busy_ms,
        "device_span_ms": span_ms, "idle_share": 1 - busy_ms / span_ms if span_ms else None,
        "top_kernels_ms": top,
    }
    log(f"train launches {res['launches']}; peak {res['peak_memory_gb']:.2f} GB; "
        f"device operations {res['profiler']['device_events']}; profiler {res['profiler']}")
    return res


# Phase 9's loss keys: the JAX Trainer's train payload for the flagship
# preset (type static, four scales) besides mode/epoch/iter.
FIT_LOSS_KEYS = ({"topview_loss", "transform_topview_loss", "transform_loss", "layout_loss",
                  "loss", "grad_norm"}
                 | {f"{k}/{s}" for k in ("min_reconstruct_loss", "scale_loss", "smooth_loss")
                    for s in range(4)})
FIT_EPOCHS = 2


class _RecordingLoader:
    """The loader as the Trainer sees it, recording each epoch's batches by
    a fingerprint of their samples (a few pixels of frame 0)."""

    def __init__(self, inner):
        self.inner, self.epochs = inner, []

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        self.epochs.append([])
        for batch in self.inner:
            self.epochs[-1] += [tuple(c[0, 0, 0, :4].tolist()) for c in batch["color"]]
            yield batch


class _RecordingStep:
    """The Trainer's step, keeping each step's metrics on the card (no
    synchronisation); every other attribute is the step's."""

    def __init__(self, step):
        self.step, self.metrics = step, []

    def __call__(self, batch):
        m = self.step(batch)
        self.metrics.append(m)
        return m

    def __getattr__(self, name):
        return getattr(self.step, name)


def phase_fit(torch, train_sites) -> dict:
    """Phase 9: the kitti_odom_1024 preset trained through the port's entry
    points -- Config.fromfile, build_model, get_dataset, DataLoader and
    Trainer.fit -- on simulated scenes (the one dataset that needs no files),
    at the preset's model: 1024^2, occ 256, B = imgs_per_gpu = 3, remat,
    road branch, frames (0, -1, 1), four scales, loss_sum 3, Adam 1e-4, clip
    35, with compute_dtype bfloat16 (the preset leaves it at float32; bf16
    is bench.py's flagship). The scenes are rendered once before the fit
    (set-up), so the fit reads them from the dataset's cache."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile

    from jperceiver_tpu_torch.config import Config
    from jperceiver_tpu_torch.data import DataLoader, get_dataset
    from jperceiver_tpu_torch.engine import Trainer
    from jperceiver_tpu_torch.models import build_model
    from jperceiver_tpu_torch.models.jperceiver import conv3x3_sites
    from jperceiver_tpu_torch.ops import cuda as kernels

    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    batch_size = int(cfg.imgs_per_gpu)
    steps = 4
    cfg.merge_from_dict({"data.name": "simulated", "data.n_scenes": steps * batch_size,
                         "model.compute_dtype": "bfloat16"})
    mcfg = cfg.model
    torch.manual_seed(0)
    model = build_model(mcfg)
    ds = get_dataset(cfg.data, training=True, with_sdf=int(mcfg.loss_sum) >= 2,
                     num_class=mcfg.num_class)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        scenes = list(ex.map(ds.__getitem__, range(len(ds))))
    render_s = time.perf_counter() - t0
    finger = {tuple(s["color"][0, 0, 0, :4].tolist()): i for i, s in enumerate(scenes)}
    if len(finger) != len(ds):
        raise AssertionError("simulated scenes share a fingerprint")
    loader = _RecordingLoader(DataLoader(ds, batch_size=batch_size, shuffle=True,
                                         num_workers=4))
    if len(loader) != steps:
        raise AssertionError(f"loader length {len(loader)}, expected {steps}")
    logs, ckpt, evals = [], [], []
    trainer = Trainer(model, cfg, loader, steps,
                      checkpoint_fn=lambda st, epoch: ckpt.append((epoch, st.iteration)),
                      eval_hook=lambda st, epoch: evals.append(epoch) or {
                          "iteration": float(st.iteration)},
                      log_fn=logs.append, log_interval=steps)
    rec = trainer.train_step = _RecordingStep(trainer.train_step)
    # The optimizer is the preset's: Adam 1e-4, clip 35, the LR step at
    # epoch 50.
    res_opt = {"type": type(rec.optimizer).__name__, "clip": rec.clip,
               "lr": [rec.schedule(i) for i in (0, 50 * steps - 1, 50 * steps)]}
    if not (res_opt["type"] == "Adam" and res_opt["clip"] == 35.0
            and res_opt["lr"][:2] == [1e-4, 1e-4] and math.isclose(res_opt["lr"][2], 1e-5)):
        raise AssertionError(f"fit optimizer {res_opt}, expected the preset's")
    # Its K3 sites are the step's, which phases 2 and 7 hold at B = FIT_B.
    fit_sites = conv3x3_sites(mcfg.height, mcfg.width, mcfg.occ_map_size,
                              branches=model.branches)
    if fit_sites != train_sites or batch_size != FIT_B:
        raise AssertionError("the fit's K3 sites or batch are not those phases 2 and 7 hold")
    bn = model.DepthEncoder.encoder.bn1
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())

    # The main path: counts set to 0 just before the fit, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"render_s": render_s, "fit_s": fit_s, "launches": launches,
           "peak_memory_gb": peak_gb, "batch": batch_size, "steps_per_epoch": steps,
           "remat_trunks": sorted(model.remat_trunks), "checkpoint_calls": ckpt,
           "optimizer": res_opt, "payloads": logs}

    # Payloads: the JAX Trainer's keys, one epoch_time an epoch.
    modes = [(p["mode"], p["epoch"]) for p in logs]
    want_modes = [m for e in range(1, FIT_EPOCHS + 1)
                  for m in (("train", e), ("val", e), ("epoch_time", e))]
    if modes != want_modes:
        raise AssertionError(f"fit payloads {modes}, expected {want_modes}")
    for p in logs:
        keys = set(p) - {"mode", "epoch"}
        want = {"train": FIT_LOSS_KEYS | {"iter"}, "val": {"iteration"},
                "epoch_time": {"seconds"}}[p["mode"]]
        if keys != want:
            raise AssertionError(f"{p['mode']} payload keys {sorted(keys ^ want)} differ")
    if ckpt != [(e, e * steps) for e in range(1, FIT_EPOCHS + 1)] or evals != [1, 2]:
        raise AssertionError(f"callbacks: checkpoint {ckpt}, eval {evals}")

    # Sample order: epoch 2's differs from epoch 1's and is set_epoch(1)'s.
    orders = [[finger[f] for f in ep] for ep in loader.epochs]
    ref = DataLoader(ds, batch_size=batch_size, shuffle=True)
    ref.set_epoch(1)
    want_order = ref._epoch_indices()[0][:steps * batch_size].tolist()
    res["sample_orders"] = orders
    if not (orders[1] != orders[0] and orders[1] == want_order and sorted(orders[0]) ==
            list(range(len(ds)))):
        raise AssertionError(f"sample orders {orders}, epoch 2 expected {want_order}")

    # Training moves: finite losses, BatchNorm statistics moving.
    losses = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
    moved = max((bn.running_mean - stats0[0]).abs().max().item(),
                (bn.running_var - stats0[1]).abs().max().item())
    res["losses"] = [m["loss"] for m in losses]
    res["grad_norms"] = [m["grad_norm"] for m in losses]  # before the clip at 35
    res["bn_running_stat_change"] = moved
    if not (len(losses) == FIT_EPOCHS * steps
            and all(math.isfinite(v) for m in losses for v in m.values()) and moved > 0):
        raise AssertionError(f"fit: losses {losses}, BN change {moved}")

    # Rates: frames/s per epoch, the loop's wait on the prefetch queue.
    secs = [p["seconds"] for p in logs if p["mode"] == "epoch_time"]
    res["epochs"] = [{"seconds": t, "frames_per_s": steps * batch_size / t,
                      "data_wait_s": sum(w), "data_wait_share": sum(w) / t,
                      "data_wait_first_batch_s": w[0], "data_wait_steps_s": w}
                     for t, w in zip(secs, trainer.data_wait_s)]
    res["frames_per_s"] = FIT_EPOCHS * steps * batch_size / fit_s
    # Past start-up: the last epoch (epoch 1 holds the first B=3 warm-up)
    # without its wait for the first batch (the prefetch thread's start),
    # the steps that a longer epoch repeats.
    last = res["epochs"][-1]
    res["steady_frames_per_s"] = steps * batch_size / (last["seconds"]
                                                       - last["data_wait_first_batch_s"])
    res["steady_data_wait_share"] = ((last["data_wait_s"] - last["data_wait_first_batch_s"])
                                     / (last["seconds"] - last["data_wait_first_batch_s"]))

    # One more epoch under the profiler: kernels a step, the card's idle share.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit(FIT_EPOCHS + 1, start_epoch=FIT_EPOCHS)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = Counter(e.name for e in dev)
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span_ms = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3

    def count(sub):
        return sum(n for k, n in names.items() if sub in k) / steps

    res["profiler_per_step"] = {
        "k1": count("reproj_fwd"), "k2": count("reproj_bwd"), "k3": count("conv3x3_bf16"),
        "k4": count("wgrad_bf16"), "k5": count("maxpool5x5_nhwc"),
        "k5_bwd": count("maxpool5x5_bwd_nhwc"), "stem_pool_bwd": count("maxpool3x3s2_bwd"),
        "device_events": sum(names.values()) / steps}
    res["profiled_epoch"] = {"device_busy_ms": busy_ms, "device_span_ms": span_ms,
                             "idle_share": 1 - busy_ms / span_ms,
                             "data_wait_s": sum(trainer.data_wait_s[-1])}
    log(f"fit: {json.dumps({k: v for k, v in res.items() if k != 'payloads'})}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    sys.path.insert(0, ROOT)
    try:
        from jperceiver_tpu_torch.models.jperceiver import conv3x3_sites
        from jperceiver_tpu_torch.ops.cuda import _build
    except ImportError as exc:
        log(f"chip_smoke: run from a checkout of the repo ({exc})")
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s")
    t0 = time.perf_counter()
    ptxas = parse_ptxas(_build.ptxas_report())
    log(f"nvcc -Xptxas -v in {time.perf_counter() - t0:.1f} s:")
    for k in ptxas:
        log(f"  {k}")

    sites = conv3x3_sites(HW, HW, OCC)
    n_k3 = sum(s["k3"] for s in sites)
    # The training step runs the road branch only; its K3 sites are the
    # eval forward's (no layout-decoder site is eligible).
    train_sites = conv3x3_sites(HW, HW, OCC, branches="road")
    n_k3_train = sum(s["k3"] for s in train_sites)
    k3 = phase_k3(torch, sites, train_sites)
    k5 = phase_k5(torch)
    sp = phase_stem_pool(torch)
    ev = phase_eval(torch)
    st = phase_stream(torch, n_k3)
    rp = phase_reproj(torch)
    cb = phase_conv_bwd(torch, train_sites)
    tr = phase_train(torch)
    ft = phase_fit(torch, train_sites)

    launches = ev["launches"]
    if launches != {k: 0 for k in launches} | {"conv3x3": n_k3, "maxpool5x5": 16}:
        raise AssertionError(f"eval main-path launches {launches}, expected "
                             f"conv3x3 {n_k3} and maxpool5x5 16 only")
    prof = ev["profiler"]
    if (prof["k3"], prof["k5"]) != (n_k3, 16):
        raise AssertionError(f"eval profiler kernel counts {prof}, expected "
                             f"K3 {n_k3} and K5 16")
    # No cotangent of a pool reaches its backward kernel in another memory
    # format than channels-last (maxpool5x5_bwd_cot_copy counts the copies).
    want = {"conv3x3": n_k3_train, "conv3x3_dgrad": n_k3_train,
            "conv3x3_wgrad": n_k3_train, "maxpool5x5": 16, "maxpool5x5_bwd": 16,
            "maxpool5x5_bwd_cot_copy": 0, "maxpool3x3s2_bwd": 4,
            "maxpool3x3s2_bwd_cot_copy": 0, "reproj_fwd": 1, "reproj_bwd": 1}
    if tr["launches"] != want:
        raise AssertionError(f"train main-path launches {tr['launches']}, expected {want}")
    tp = tr["profiler"]
    if (tp["k1"], tp["k2"], tp["k3"], tp["k4"], tp["k5"], tp["k5_bwd"], tp["stem_pool_bwd"]) != (
            1, 1, 2 * n_k3_train, n_k3_train, 16, 16, 4):
        raise AssertionError(f"train profiler kernel counts {tp}")

    # Phase 9 under remat: every K3 site and CRP pool of a checkpointed
    # trunk runs its forward again in the backward.
    trunks = set(ft["remat_trunks"])
    n_k3_re = sum(s["k3"] for s in train_sites if s["module"] in trunks)
    n_k5_re = 16 if "DepthDecoder" in trunks else 0
    n_fit = FIT_EPOCHS * ft["steps_per_epoch"]
    per_step = {"conv3x3": n_k3_train + n_k3_re, "conv3x3_dgrad": n_k3_train,
                "conv3x3_wgrad": n_k3_train, "maxpool5x5": 16 + n_k5_re,
                "maxpool5x5_bwd": 16, "maxpool5x5_bwd_cot_copy": 0, "maxpool3x3s2_bwd": 4,
                "maxpool3x3s2_bwd_cot_copy": 0, "reproj_fwd": 1, "reproj_bwd": 1}
    ft["expected_launches_per_step"] = per_step
    if ft["launches"] != {k: v * n_fit for k, v in per_step.items()}:
        raise AssertionError(f"fit main-path launches {ft['launches']}, expected "
                             f"{n_fit} x {per_step}")
    fp = ft["profiler_per_step"]
    if (fp["k1"], fp["k2"], fp["k3"], fp["k4"], fp["k5"], fp["k5_bwd"], fp["stem_pool_bwd"]) != (
            1, 1, per_step["conv3x3"] + n_k3_train, n_k3_train, per_step["maxpool5x5"], 16, 4):
        raise AssertionError(f"fit profiler kernel counts a step {fp}, expected {per_step}")

    def entry(kid, name, src, replaces, count, err, per, bound_by):
        lib = per["library_ms"]
        return {"id": kid, "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": count, "max_abs_err": err,
                "ms": per["ms"], "plain_ms": per["plain_ms"], "bound_ms": per["bound_ms"],
                "bound_by": bound_by, "library_ms": lib,
                "bound_share": per["bound_ms"] / per["ms"],
                "library_ratio": None if lib is None else per["ms"] / lib}

    rps, cbs, tl, fl = rp["per_step"], cb["per_step"], tr["launches"], ft["launches"]

    def pick(d, prefix):
        return {k: d[prefix + k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    # Times are per training step: each kernel summed over its launches in
    # one 1024^2 bf16 step, at their own shapes.
    table = {"kernels": [
        entry("K1", "reproj_fwd", K12_SRC, "jperceiver_tpu/ops/pallas/reproj.py:153",
              tl["reproj_fwd"], rp["k1_max_abs_err"], pick(rps, "k1_"), rps["bound_by_fwd"]),
        entry("K2", "reproj_bwd", K12_SRC, "jperceiver_tpu/ops/pallas/reproj.py:164",
              tl["reproj_bwd"], rp["k2_max_abs_err"], pick(rps, "k2_"), rps["bound_by_bwd"]),
        entry("K3", "conv3x3_fwd", K3_SRC, "jperceiver_tpu/ops/pallas/conv3x3.py:57",
              tl["conv3x3"], k3["max_abs_err"], k3["per_forward"], k3["bound_by"]),
        entry("K3-dgrad", "conv3x3_dgrad", K3_SRC, "jperceiver_tpu/ops/pallas/conv3x3.py:242",
              tl["conv3x3_dgrad"], cb["dgrad_max_abs_err"], pick(cbs, "dgrad_"), cb["bound_by"]),
        entry("K4", "conv3x3_wgrad", K4_SRC, "jperceiver_tpu/ops/pallas/conv3x3.py:145",
              tl["conv3x3_wgrad"], cb["wgrad_max_abs_err"], pick(cbs, "wgrad_"), cb["bound_by"]),
        entry("K5", "maxpool5x5_fwd", K5_SRC, "jperceiver_tpu/ops/pallas/maxpool.py:183",
              tl["maxpool5x5"], k5["max_abs_err"], k5["per_forward"], k5["bound_by"]),
        # The backward is `_mp_bwd`, XLA in JAX (no Pallas kernel); no
        # PyTorch call routes a tie to every maximum, so library_ms is null.
        dict(entry("K5-bwd", "maxpool5x5_bwd", K5_SRC, "jperceiver_tpu/ops/pallas/maxpool.py:100",
                   tl["maxpool5x5_bwd"], k5["bwd_max_abs_err"], k5["per_step_bwd"],
                   k5["bound_by"]),
             max_pool2d_bwd_ms_for_scale=k5["per_step_bwd"]["max_pool2d_ms"]),
        # `_mp3_bwd`, XLA in JAX (no Pallas kernel); library_ms null as above.
        dict(entry("stem-pool-bwd", "maxpool3x3s2_bwd", K3S2_SRC,
                   "jperceiver_tpu/ops/pallas/maxpool.py:157", tl["maxpool3x3s2_bwd"],
                   sp["max_abs_err"], sp["per_step"], sp["bound_by"]),
             max_pool2d_bwd_ms_for_scale=sp["per_step"]["max_pool2d_bwd_ms"]),
    ]}
    for row in table["kernels"]:  # launches of phase 9's fit, its own main path
        row["fit_launches"] = fl[{"conv3x3_fwd": "conv3x3", "maxpool5x5_fwd": "maxpool5x5"}
                                 .get(row["name"], row["name"])]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "ptxas": ptxas, "k3_sites": n_k3,
                   "k3": k3, "k5": k5, "stem_pool": sp, "eval": ev, "stream": st, "reproj": rp,
                   "conv_bwd": cb, "train": tr, "fit": ft,
                   "seconds": time.perf_counter() - t_start, "table": table},
                  f, indent=1)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
