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
     the plain pool, TF32 off), bf16 finite and timed both ways (the eager
     step, graph=False), kernel launches counted on the main path (the
     captured step, a replay) and in a profiler trace of a replay;
  5. streaming inference over 9 frames at 1024^2 in bf16, chunk 4 (each
     chunk a replay of its graph after a warm-up run), its kernel launches
     counted and its rotations checked orthonormal;
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
     phase 9's B=3 (K4 also against float64: within 2x the plain version's
     distance at every site; the ratio is logged at B=1 too) and K4 at
     513 -> 256 @ 256^2 at B=8, untimed; every timed row logs the spins
     its readings were queued behind (`time_ms`, `take_spins`);
  8. the flagship training step at 1024^2 (bench.py's configuration: road
     branch, B=1, Adam, clip 35), random weights from a seed: fp32 with the
     kernels on against off, both against the step in float64 (losses and
     gradients; the library route's own spread under a rounding-level
     change of the input sets each gradient's bound), bf16 for 20 steps on
     one batch (finite, falling loss, BatchNorm statistics moving; the
     captured step), frames/s with the kernels on and off in turns (the
     eager step), the kernel launches of one step (a replay of the captured
     step) from the counters and a profiler trace (K1 once, the CRP
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
     the card's idle share;
 10. the workflow around the fit, through the port's tools at the same
     preset: `tools/train.py` on a config file written from it (2 epochs of
     4 steps, validation and a checkpoint each epoch: the starting state's
     checkpoint and one an epoch, the
     train/val/epoch_time payloads, finite val metrics over every
     validation sample), `--resume_from` to a third epoch (the step holds
     the saved model, optimizer state and generator bit for bit, iteration
     8, epoch 3's checkpoint written and bit for bit that of the same
     config run 3 epochs uninterrupted), `fit_resilient` after a loader's
     RuntimeError in epoch 2 (one restart, from the epoch-1 checkpoint, to
     iteration 8, its epoch-2 checkpoint bit for bit the uninterrupted
     run's; a TypeError raised at once), `tools/eval_depth.py` on the
     epoch-2 checkpoint (the hook's depth row within 1e-6 relative) and
     `tools/draw_odometry.py` over a 110-frame drive (110 pose rows,
     orthonormal rotations, a finite 100 m segment error; the plot only
     where matplotlib is installed); each stage's kernel launches from the
     counters (the training steps at phase 9's counts a step, each eval
     forward at its K3 sites and 16 CRP pools), its seconds and peak
     memory, the checkpoint's size and save and restore times.

 11. data parallel at the same preset (1024^2, occ 256, remat), B = 3 a
     rank, in child processes of this script (`--child`), each with a time
     limit: (a) two ranks over gloo on the one card: one step for
     bn_groups 1 and 2 against one process at B = 6 with the same weights,
     batch, noise and dropout draws, in fp32 with the kernels (losses
     within rtol 1e-4, each trunk's averaged gradient within 3x the
     one-process step's spread -- kernels on against off, or under a
     rounding-level change of the input pixels -- plus 1e-3 of its norm),
     each rank's launches a step, and ZeRO-1 over three whole steps bit
     for bit the plain step (gradients a step and weights), and one step
     with each cross-rank reduction swapped for a float64 one (BatchNorm's
     moments, the loss denominators, DDP's bucket sum), the trunk
     distances logged and, with BatchNorm's moments in float64 on both
     sides, every parameter's gradient within 3x its on/off distance +
     1e-3 of its scale; (b) two ranks of
     `tools/train.py --launcher pytorch --dist_backend gloo` in bf16, 2
     epochs of 4 steps with validation on 13 scenes (launches per rank,
     rank 0 alone writing, n_eval_samples 13, finite losses, the step
     eager); (c) one rank of the same CLI on NCCL, its default on the
     card, 7 epochs of 2 steps: the step captured at its 12th, past DDP's
     warm-ups;
 12. `tools/profile_step.py` for 5 steps of the 1024^2 bf16 step, then
     `tools/trace_summary.py` on its trace (K1-K5 and both pool backwards
     by name with device time), and `tools/complexity.py` at 1024^2 (its
     parameter total the model's);
 13. kitti_files: the kitti_odom_1024 preset trained from a KITTI odometry
     file tree (PNGs at KITTI's sizes, rendered; velodyne scans and
     calibration files) through the packaged split lists (`data.split_dir`
     unset): `Trainer.fit` for 2 epochs of 4 steps at B=3 with the eval
     hook's validation (its depth row from velodyne), each hand kernel's
     launches at phase 9's counts a step, fit frames/s past start-up, the
     prefetch wait, a sample's decode and load time, the idle share of a
     profiled epoch; then `tools/draw_odometry.py` without `--gt_dir` on a
     271-frame sequence 04, scored against the packaged 04.txt (271 pose
     rows, segments, finite errors);
 14. (run after phase 9) in a child process with cuBLAS's fixed workspace:
     phase 8's fp32 step and the fit's fp32 step at B=3, each run twice
     from the same state with the port's formulations, the parent's, and
     the parent's for one repaired operation at a time (the modules whose
     gradients differ), phase 8's bf16 step twice; the bf16 step's device
     time with the parent's and the port's formulations in turns; the
     operations that warn under deterministic algorithms. It fails unless
     the port's fp32 and bf16 steps repeat bit for bit (all eager steps);
 15. graph: the entry points as CUDA graphs (`engine/graphs.py`, the
     counterpart of the JAX package's jit) against their eager twins
     (graph=False), at 1024^2: phase 8's step in fp32 and bf16 and the
     fit's step (B=3, remat, bf16), 3 steps each across an LR milestone
     (fp32, bf16), every metric, gradient, weight, Adam moment, BatchNorm
     statistic and the generator bit for bit; the eval step and streaming
     (10 frames, chunks 4, 4, 1) bit for bit; `linalg.inv_ex` as `inv`;
     each hand kernel's launches in a profiled replay by name equal to the
     eager step's counters (phases 8 and 9) and the replay's; a captured
     `.item()` raises; times
     captured against eager (not gated);
 16. ddp_graph: the captured data-parallel step (DDP, the global or
     per-rank BatchNorm, the loss denominators and ZeRO-1 in one CUDA
     graph a rank) on one NCCL rank a card (one on a one-card machine),
     at the fit's step (B=3 a rank, remat, bf16): captured against its
     eager twin over 11 warm-ups, the capture and three replays across an
     LR milestone, every metric, gradient, weight, Adam moment, BatchNorm
     statistic and the generator bit for bit, for bn_groups 1 (and the
     world size where it differs) and ZeRO-1 (graph=None at one rank,
     graph=True at more, where None stays eager); each hand kernel's launches
     in a profiled replay at phase 9's counts a step, NCCL's kernels by
     name; times (not gated). `python3 chip_smoke.py --ddp-graph 2 4`
     runs phase 16 alone on 2 and then 4 cards;
 17. (run after phase 8) K3's and K4's TF32 paths, which fp32 operands
     take where `torch.backends.cudnn.allow_tf32` is set (every other phase
     runs with it off): at every K3 site of the training step at B = 1 and
     3, as the forward, as the data-grad and as K4's weight gradient,
     against the plain version on the operands rounded to TF32
     (`round_tf32`), within TF32_TOL_GAPS of the site's TF32 gap, which a
     kernel that truncates its operands fails (`_truncate_tf32`, read
     beside), each call counted by `tf32_launch_counts()`; timed at B = 1
     beside its bound at 494.7 TFLOP/s, cuDNN's TF32, the exact fp32
     kernel and the plain version; then phase 8's fp32 step captured with
     the flag on and off (one step object: the flag is in the graph's
     key), each setting's launches and TF32 launches in a replay from the
     counters, and its K3 and K4 kernels by name in a profiled replay (TF32
     or exact, none of the other; K3's filter, `conv3x3_f32`, matches no K4
     kernel). `python3 chip_smoke.py --k3-tf32` runs phase 17 alone.

Phases 9, 10 and 13 run the step and the eval hook's forward as CUDA
graphs, the default on the card (`make_train_step(graph=None)`); the
counters add a graph's launches at each replay.

Prints the card line, a JSON line describing every kernel (with its
launches in phases 8-11, 13, 16 and 17), and last the device line. Full results go to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device, outside
a checkout of the repo, or when a phase fails.
"""

from __future__ import annotations

import functools
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
# TF32 tensor cores, dense (half the bf16 rate), for K3's TF32 path.
PEAK_TF32 = 494.7e12
# K3's TF32 path within this share of a site's TF32 gap of the plain version
# on the operands rounded to TF32 (phase 17). Rounded to nearest it reads a
# few hundredths; a kernel that truncates the activation reads 1.7-2.1.
TF32_TOL_GAPS = 0.25
# Cycles of torch.cuda._sleep per second the host takes to enqueue the
# timed calls: 1.5x the H100's 1.98 GHz boost clock, so the spin outlasts it.
SPIN_CYCLES_PER_S = 3e9
# How often `time_ms` times again, behind a spin twice as long and with half
# the calls, a reading whose spin ended before its calls were queued.
SPIN_RETRIES = 5
SPINS: list[dict] = []  # the spin of every `time_ms` reading, until `take_spins`
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
    are queued behind a spin kernel sized to outlast the host's enqueue of
    them, so the events time the device running them one after another,
    not the host enqueueing them. Once the calls are queued, the start event
    must still be pending (the spin still running); if it has completed,
    the reading would hold host time, and the calls are timed again behind
    a spin twice as long, and half as many of them (the device's launch
    queue holds about a thousand operations: a plain version of many small
    operations a call fills it, and the host then waits on the spin
    whatever its length), up to SPIN_RETRIES times; then it raises. The
    spin and the number of calls each reading used are appended to SPINS
    (`take_spins`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(SPIN_CYCLES_PER_S * enqueue_s) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(SPIN_RETRIES + 1):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        spin_outlasted = not start.query()
        end.record()
        end.synchronize()
        if spin_outlasted:
            SPINS.append({"spin_cycles": cycles, "retries": attempt, "reps": reps,
                          "enqueue_ms": enqueue_s * 1e3})
            return start.elapsed_time(end) / reps
        cycles *= 2
        reps = max(1, reps // 2)
    raise RuntimeError(f"time_ms: a spin of {cycles // 2} cycles ended before {reps} calls "
                       f"were queued, {SPIN_RETRIES} retries")


def take_spins() -> dict:
    """The spins of the `time_ms` calls since the last take: how many
    readings, the longest spin, the most retries any needed and the fewest
    calls any timed. Every reading in it was queued behind a spin that was
    still running."""
    out = {"readings": len(SPINS),
           "max_spin_cycles": max((s["spin_cycles"] for s in SPINS), default=0),
           "max_retries": max((s["retries"] for s in SPINS), default=0),
           "min_reps": min((s["reps"] for s in SPINS), default=0)}
    SPINS.clear()
    return out


def _device_events(prof) -> list:
    """A profiler trace's operations on the device (kernels, copies, sets),
    without its GPU user annotations: the optimizer's `Optimizer.step#...`
    range is a device event whose duration is the span of the optimizer's
    work, not work, and summed with the kernels it counted them twice."""
    return [e for e in prof.events()
            if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]


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
                row["spins"] = take_spins()
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
                    1 for e in _device_events(prof))
        row["spins"] = take_spins()
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
                    1 for e in _device_events(prof))
        row["spins"] = take_spins()
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

    # fp32, kernels on against off: the eager step (graph=False), whose
    # forward the CCT probes' hooks see and whose routing set_kernels turns.
    model = build_model(torch, torch.float32)
    step = make_eval_step(model, cfg_on, graph=False)
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

    # bf16: finite, and ms/frame with the kernels on and off, in turns, on
    # the eager step (graph=False; phase 15 times the captured one).
    model = build_model(torch, torch.bfloat16)
    step = make_eval_step(model, cfg_on, graph=False)

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

    # The main path, the step as a user gets it (a CUDA graph): warmed up
    # and captured first; counts set to 0 just before a replay, read just
    # after.
    set_kernels(model, True, True, True)
    step = make_eval_step(model, cfg_on)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
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
    dev = _device_events(prof)
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
    run(frames)  # warm-up: the first chunk runs eagerly, the second captures
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
        row["spins"] = take_spins()
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
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv, _tma_operand, _wgrad_tma

    grad = torch.nn.grad
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"]) for s in sites if s["k3"])
    rows, tot = [], Counter()
    err_d = err_w = 0.0
    ops_t = bytes_t = 0.0
    # bf16 and fp32 at B=1 (timed in bf16), then bf16 at phase 9's B = FIT_B
    # (K4's pixel split depends on B*H*W) and the widest site at B = 8, where
    # a split sums the most tiles, untimed.
    cases = [(shape, dtype, 1) for shape in sorted(shapes)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, torch.bfloat16, FIT_B) for shape in sorted(shapes)]
    cases.append((max(shapes), torch.bfloat16, 8))
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
        if dtype == torch.bfloat16:
            # K4's and the plain version's distances to float64 (cuDNN in
            # fp64 on the same bf16 inputs), at B = 1 and at the larger
            # batches: which of the two moves with B.
            dw64 = grad.conv2d_weight(x.double(), wt.shape, gy.double(), padding=pad)
            row.update(wgrad_err_f64=(dw.double() - dw64).abs().max().item(),
                       wgrad_plain_err_f64=(dw_ref.double() - dw64).abs().max().item())
            row["wgrad_f64_over_plain"] = row["wgrad_err_f64"] / row["wgrad_plain_err_f64"]
            row["wgrad_gate_share"] = ew / row["wgrad_tol"]
            del dw64
        if bsz != 1:
            rows.append(row)
            log(f"K3-dgrad/K4 {row}")
            # K4 sums a split's tiles in its wgmma accumulator only a few at
            # a time (`k4_plan`), so its distance to float64 stays within 2x
            # the plain version's at every site of the fit's step.
            if bsz == FIT_B and not row["wgrad_f64_over_plain"] <= 2.0:
                raise AssertionError(f"K4 at B={bsz} is {row['wgrad_f64_over_plain']:.2f}x "
                                     f"the plain version's distance to float64: {row}")
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
                wgrad_ms=time_ms(torch, lambda: _wgrad_tma(xh, gy, pad), reps=10),
                wgrad_plain_ms=time_ms(torch, lambda: conv3x3_wgrad_plain(x, gy, pad), reps=5),
                wgrad_library_ms=time_ms(torch, lambda: grad.conv2d_weight(x, wt.shape, gy, padding=pad), reps=10))
            for k in ("dgrad_", "wgrad_"):
                row[k + "bound_share"] = row[k + "bound_ms"] / row[k + "ms"]
                row[k + "library_ratio"] = row[k + "ms"] / row[k + "library_ms"]
            row.update(
                dgrad_enqueue_ms=enqueue_ms(torch, lambda: _conv(gy, wflip, None, 2 - pad,
                                                             "conv3x3_dgrad")),
                wgrad_enqueue_ms=enqueue_ms(torch, lambda: _wgrad_tma(xh, gy, pad)))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot["dgrad_" + k] += count * row["dgrad_" + k]
                tot["wgrad_" + k] += count * row["wgrad_" + k]
            ops_t += count * n_ops / PEAK_BF16
            bytes_t += count * (c * hin * win + o * h * w) * item / HBM_BYTES_S
        row["spins"] = take_spins()
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
        # Eager (graph=False): the CCT probes' hooks see its forward.
        step = make_train_step(model, dict(TRAIN_CFG, use_pallas_reproj=on,
                                           pallas_reproj_bf16=False), seed=0,
                               steps_per_epoch=STEPS_PER_EPOCH, graph=False)
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

    # Frames/s, kernels on and off in turns (host clock, synchronized; B=1),
    # of the eager step (graph=False; phase 15 times the captured one).
    step_off = make_train_step(model, dict(TRAIN_CFG, use_pallas_reproj=False), seed=2,
                               steps_per_epoch=STEPS_PER_EPOCH, graph=False)
    step_on = make_train_step(model, TRAIN_CFG, seed=3, steps_per_epoch=STEPS_PER_EPOCH,
                              graph=False)

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

    # The main path, the step as a user gets it (a CUDA graph), warmed up
    # and captured first: counts set to 0 just before one step (a replay),
    # read just after.
    set_kernels(model, True, True, True, stem_pool=True)
    step_on = make_train_step(model, TRAIN_CFG, seed=3, steps_per_epoch=STEPS_PER_EPOCH)
    for _ in range(2):
        step_on(batch)
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
    dev = _device_events(prof)
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


def _truncate_tf32(torch, t):
    """t (fp32) with its 13 low mantissa bits cleared: what the tensor cores
    make of fp32 bits fed to a TF32 product as they are."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def phase_k3_tf32(torch, train_sites) -> dict:
    """Phase 17: K3's and K4's TF32 paths at the training step's K3 sites
    (whose weight gradients are K4's), then the captured fp32 step with
    `cudnn.allow_tf32` on and off."""
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.ops.cuda import conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv, round_tf32

    F, grad, flags = torch.nn.functional, torch.nn.grad, torch.backends.cudnn
    g = torch.Generator(device="cuda").manual_seed(17)
    per_step = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"])
                       for s in train_sites if s["k3"])
    rows, tot, worst = [], Counter(), 0.0
    # Each site as the forward (with a bias) and as the data-grad (K3 at pad
    # 2 - pad on the cotangent, flipped and transposed weights), against
    # the plain version on the operands rounded to TF32 (their products
    # exact in fp32) in units of the site's TF32 gap, the largest distance
    # between the plain version on the exact and on the rounded operands.
    # A kernel fed the activation's fp32 bits as they are truncates it: the
    # plain version on the truncated activation and rounded weight reads
    # `trunc_gaps`, which the limit must fail.
    for bsz in (1, FIT_B):
        for (c, o, h, w, pad), count in sorted(per_step.items()):
            hin, win = h + 2 - 2 * pad, w + 2 - 2 * pad
            x = torch.randn(bsz, c, hin, win, device="cuda", generator=g)
            x = x.contiguous(memory_format=torch.channels_last)
            wt = torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)
            b = 0.1 * torch.randn(o, device="cuda", generator=g)
            gy = torch.randn(bsz, o, h, w, device="cuda", generator=g)
            gy = gy.contiguous(memory_format=torch.channels_last)
            wflip = wt.flip(2, 3).transpose(0, 1)
            row = {"batch": bsz, "c_in": c, "c_out": o, "h": h, "w": w, "pad": pad,
                   "sites_per_step": count}
            for name, a, wk, bias, pd, counter, cin, cout, (ei, eo) in (
                    ("fwd", x, wt, b, pad, "conv3x3", c, o, ((hin, win), (h, w))),
                    ("dgrad", gy, wflip, None, 2 - pad, "conv3x3_dgrad", o, c,
                     ((h, w), (hin, win)))):
                flags.allow_tf32 = False
                ref = conv3x3_plain(round_tf32(a), round_tf32(wk), bias, pd)
                gap = (conv3x3_plain(a, wk, bias, pd) - ref).abs().max().item()
                trunc = conv3x3_plain(_truncate_tf32(torch, a), round_tf32(wk), bias, pd)
                flags.allow_tf32 = True
                n0 = kernels.tf32_launch_counts()[counter]
                y = _conv(a, wk, bias, pd, counter)
                torch.cuda.synchronize()
                row[name + "_err_gaps"] = (y - ref).abs().max().item() / gap
                row[name + "_trunc_gaps"] = (trunc - ref).abs().max().item() / gap
                row[name + "_tf32_counted"] = kernels.tf32_launch_counts()[counter] - n0
                if not (row[name + "_err_gaps"] <= TF32_TOL_GAPS < row[name + "_trunc_gaps"]
                        and row[name + "_tf32_counted"] == 1
                        and tuple(y.shape) == (bsz, cout, *eo)):
                    raise AssertionError(f"K3 TF32 {name} against the plain version on "
                                         f"rounded operands: {row}")
                worst = max(worst, row[name + "_err_gaps"])
                del ref, trunc, y
                if bsz != 1:
                    continue
                n_ops = 2.0 * eo[0] * eo[1] * cout * 9 * cin
                n_bytes = 4.0 * (cin * ei[0] * ei[1] + cout * 9 * cin + cout * eo[0] * eo[1])
                bnd, by = bound_ms(n_bytes, n_ops, PEAK_TF32)
                lib = (functools.partial(F.conv2d, x, wt, b, padding=pad) if name == "fwd"
                       else functools.partial(grad.conv2d_input, x.shape, wt, gy, padding=pad))
                row.update({
                    name + "_bound_ms": bnd, name + "_bound_by": by,
                    # The wrapper's rounded weight copy and the 544-wide
                    # copy of the 513-channel concat included.
                    name + "_ms": time_ms(torch, lambda: _conv(a, wk, bias, pd, counter),
                                          reps=10),
                    name + "_library_ms": time_ms(torch, lib, reps=10)})
                flags.allow_tf32 = False
                row.update({
                    name + "_exact_ms": time_ms(torch, lambda: _conv(a, wk, bias, pd, counter),
                                                reps=10),
                    name + "_plain_ms": time_ms(torch, lambda: conv3x3_plain(a, wk, bias, pd),
                                                reps=10)})
                row[name + "_bound_share"] = bnd / row[name + "_ms"]
                for k in ("ms", "library_ms", "exact_ms", "plain_ms", "bound_ms"):
                    tot[f"{name}_{k}"] += count * row[f"{name}_{k}"]
            # K4, the weight gradient of the forward's site: the plain
            # version on the rounded operands (x and the cotangent, both
            # rounded by the kernel), the gap and the truncated reading as
            # above.
            flags.allow_tf32 = False
            ref = conv3x3_wgrad_plain(round_tf32(x), round_tf32(gy), pad)
            gap = (conv3x3_wgrad_plain(x, gy, pad) - ref).abs().max().item()
            trunc = conv3x3_wgrad_plain(_truncate_tf32(torch, x), _truncate_tf32(torch, gy), pad)
            flags.allow_tf32 = True
            n0 = kernels.tf32_launch_counts()["conv3x3_wgrad"]
            dw = conv3x3_wgrad(x, gy, pad)
            torch.cuda.synchronize()
            row["wgrad_err_gaps"] = (dw - ref).abs().max().item() / gap
            row["wgrad_trunc_gaps"] = (trunc - ref).abs().max().item() / gap
            row["wgrad_tf32_counted"] = kernels.tf32_launch_counts()["conv3x3_wgrad"] - n0
            if not (row["wgrad_err_gaps"] <= TF32_TOL_GAPS < row["wgrad_trunc_gaps"]
                    and row["wgrad_tf32_counted"] == 1 and tuple(dw.shape) == (o, c, 3, 3)):
                raise AssertionError(f"K4 TF32 against the plain version on rounded operands: "
                                     f"{row}")
            worst = max(worst, row["wgrad_err_gaps"])
            del ref, trunc, dw
            if bsz == 1:
                n_ops = 2.0 * 9 * c * o * h * w
                n_bytes = 4.0 * (c * hin * win + o * h * w + o * c * 9)
                bnd, by = bound_ms(n_bytes, n_ops, PEAK_TF32)
                row.update({
                    "wgrad_bound_ms": bnd, "wgrad_bound_by": by,
                    # The 544-wide copy of the 513-channel concat included,
                    # which the step makes once, in the forward, for K3 and K4.
                    "wgrad_ms": time_ms(torch, lambda: conv3x3_wgrad(x, gy, pad), reps=10),
                    "wgrad_library_ms": time_ms(torch, lambda: grad.conv2d_weight(
                        x, (o, c, 3, 3), gy, padding=pad), reps=10)})
                flags.allow_tf32 = False
                row.update({
                    "wgrad_exact_ms": time_ms(torch, lambda: conv3x3_wgrad(x, gy, pad),
                                              reps=10),
                    "wgrad_plain_ms": time_ms(torch, lambda: conv3x3_wgrad_plain(x, gy, pad),
                                              reps=10)})
                row["wgrad_bound_share"] = bnd / row["wgrad_ms"]
                for k in ("ms", "library_ms", "exact_ms", "plain_ms", "bound_ms"):
                    tot[f"wgrad_{k}"] += count * row[f"wgrad_{k}"]
            row["spins"] = take_spins()
            rows.append(row)
            log(f"K3 TF32 {row}")
            del x, gy, wt, wflip
    flags.allow_tf32 = False
    torch.cuda.empty_cache()

    # The main path: the captured fp32 step (phase 8's, with fp32 operands
    # for the reprojection kernels), one step object, the flag on and then
    # off; the flag is part of a graph's key, so each setting captures and
    # replays its own graph. Counts set to 0 just before a replay, read
    # just after; then a profiled replay's K3 kernels by name.
    from torch.profiler import ProfilerActivity, profile

    batch = batch_to(synthetic_batch(1, HW, HW, OCC, seed=0), "cuda")
    model = build_model(torch, torch.float32, "road")
    step = make_train_step(model, dict(TRAIN_CFG, pallas_reproj_bf16=False), seed=0,
                           steps_per_epoch=STEPS_PER_EPOCH)
    n_k3 = sum(per_step.values())
    main = {}
    for on in (True, False):
        flags.allow_tf32 = on
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        m = step(batch)
        torch.cuda.synchronize()
        got = {"launches": kernels.launch_counts(), "tf32_launches": kernels.tf32_launch_counts(),
               "loss": float(m["loss"])}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch)
            torch.cuda.synchronize()
        # K3's kernels by name, and K4's apart (no K4 name holds K3's).
        events = _device_events(prof)
        for kernel, pattern in (("", "conv3x3_f32"), ("k4_", "wgrad_f32")):
            dev = [e for e in events if pattern in e.name]
            tf32 = [e for e in dev if "tf32" in e.name]
            exact = [e for e in dev if "tf32" not in e.name]
            got.update({
                f"profiled_{kernel}tf32_kernels": len(tf32),
                f"profiled_{kernel}exact_kernels": len(exact),
                f"{kernel}tf32_kernel_ms": sum(e.time_range.elapsed_us() for e in tf32) / 1e3,
                f"{kernel}exact_kernel_ms": sum(e.time_range.elapsed_us() for e in exact) / 1e3})
        n = n_k3 if on else 0
        want = {"conv3x3": n, "conv3x3_dgrad": n, "conv3x3_wgrad": n}
        n_tf32, n_exact = (2 * n_k3, 0) if on else (0, 2 * n_k3)
        if not (got["tf32_launches"] == want
                and (got["launches"]["conv3x3"], got["launches"]["conv3x3_dgrad"],
                     got["launches"]["conv3x3_wgrad"]) == (n_k3, n_k3, n_k3)
                and (got["profiled_tf32_kernels"], got["profiled_exact_kernels"])
                == (n_tf32, n_exact)
                and (got["profiled_k4_tf32_kernels"], got["profiled_k4_exact_kernels"])
                == (n_tf32 // 2, n_exact // 2) and math.isfinite(got["loss"])):
            raise AssertionError(f"captured fp32 step, allow_tf32 {on}: {got}, expected TF32 "
                                 f"launches {want}, {n_tf32} TF32 / {n_exact} exact K3 kernels "
                                 f"and {n_tf32 // 2} / {n_exact // 2} K4 kernels")
        main["tf32_on" if on else "tf32_off"] = got
        log(f"K3/K4 TF32 main path, allow_tf32 {on}: {got}")
    del step, model
    flags.allow_tf32 = False
    torch.cuda.empty_cache()
    return {"rows": rows, "max_err_gaps": worst, "tol_gaps": TF32_TOL_GAPS,
            "per_step": dict(tot), "main_path": main}


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
    """The Trainer's step, keeping a copy of each step's metrics on the card
    (no synchronisation; a captured step's metrics are its graph's static
    outputs, which the next step writes over); every other attribute is the
    step's."""

    def __init__(self, step):
        self.step, self.metrics = step, []

    def __call__(self, batch):
        m = self.step(batch)
        self.metrics.append({k: v.clone() for k, v in m.items()})
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
    dev = _device_events(prof)
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
    res["captures"] = trainer.train_step.graphs.captures
    res["capture_s"] = trainer.train_step.graphs.capture_s
    del trainer, rec

    # The eager twin of the same fit (graph=False, the same weights and
    # scenes, no callbacks), for phase 15: frames/s past start-up.
    torch.manual_seed(0)
    elogs = []
    eager = Trainer(build_model(mcfg), cfg, loader, steps, log_fn=elogs.append,
                    log_interval=steps, graph=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager.fit(FIT_EPOCHS)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    secs = [p["seconds"] for p in elogs if p["mode"] == "epoch_time"][-1]
    first = eager.data_wait_s[-1][0]
    res["eager_twin"] = {"graphed": eager.train_step.graphed, "fit_s": t_fit,
                         "frames_per_s": FIT_EPOCHS * steps * batch_size / t_fit,
                         "steady_frames_per_s": steps * batch_size / (secs - first),
                         "losses": [p["loss"] for p in elogs if p["mode"] == "train"]}
    del eager
    torch.cuda.empty_cache()
    log(f"fit: {json.dumps({k: v for k, v in res.items() if k != 'payloads'})}")
    return res


def _write_config(cfg, path: str) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.to_dict().items()))
    return path


def _same(torch, a, b) -> bool:
    """Whether two nests of tensors (dtypes included) and values are equal,
    bit for bit."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(torch, x, y) for x, y in zip(a, b))
    return a == b


def _same_state(torch, step, ck) -> bool:
    """Whether a `TrainStep` holds a checkpoint's model, optimizer state
    (dtypes included), iteration and generator, bit for bit."""
    return (_same(torch, step.model.state_dict(), ck["state_dict"])
            and _same(torch, step.optimizer.state_dict(), ck["optimizer"])
            and step.iteration == ck["iteration"]
            and _same(torch, step.generator.get_state(), ck["generator"]))


def _same_checkpoints(torch, path_a: str, path_b: str) -> dict:
    """Which parts of two checkpoints are equal, bit for bit: model,
    optimizer state, iteration, generator and epoch."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (path_a, path_b))
    return {k: _same(torch, a[k], b[k])
            for k in ("state_dict", "optimizer", "iteration", "generator", "epoch")}


def phase_workflow(torch, train_sites, per_step) -> dict:
    """Phase 10: the user's workflow through the port's tools, at the
    kitti_odom_1024 preset as phase 9 trains it (1024^2, occ 256, B = 3,
    remat, road branch, bf16 compute, simulated scenes):
      1. `tools/train.py` on a config file written from the preset (2
         epochs, validation and a checkpoint each epoch, 4 steps an epoch);
      2. the same CLI resumed (`--resume_from`) to 3 epochs, its epoch-3
         checkpoint bit for bit that of the same config run for 3 epochs
         uninterrupted;
      3. `fit_resilient` restarting after a loader's RuntimeError in epoch
         2, from the epoch-1 checkpoint, its epoch-2 checkpoint bit for bit
         the uninterrupted run's (and a TypeError not retried);
      4. `tools/eval_depth.py` on the epoch-2 checkpoint;
      5. `tools/draw_odometry.py` on a 110-frame drive rendered at 256^2
         (the tool resizes the frames to 1024^2).
    Kernel launches come from the counters."""
    import glob
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from jperceiver_tpu_torch.config import Config
    from jperceiver_tpu_torch.data import loader as loader_mod
    from jperceiver_tpu_torch.engine import checkpoint as ckpt_mod
    from jperceiver_tpu_torch.engine import trainer as trainer_mod
    from jperceiver_tpu_torch.engine.eval_hook import DEPTH_KEYS
    from jperceiver_tpu_torch.evaluation.trajectory import load_kitti_poses
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.tools import draw_odometry, eval_depth
    from jperceiver_tpu_torch.tools import train as train_cli
    from jperceiver_tpu_torch.tools.acceptance import render_odometry_sequence

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    res: dict = {"stages": {}, "launches": {}}
    steps, epochs = 4, FIT_EPOCHS
    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    batch = int(cfg.imgs_per_gpu)
    cfg.merge_from_dict({"data.name": "simulated", "data.n_scenes": steps * batch,
                         "data.in_path": os.path.join(root, "seq"),
                         "model.compute_dtype": "bfloat16", "total_epochs": epochs,
                         "log_config.interval": steps})
    if not (cfg.validate and cfg.checkpoint_config.interval == 1 and batch == FIT_B):
        raise AssertionError("the preset no longer validates and checkpoints every epoch")
    cfg2 = _write_config(cfg, os.path.join(root, "epochs2.py"))
    cfg.merge_from_dict({"total_epochs": epochs + 1})
    cfg3 = _write_config(cfg, os.path.join(root, "epochs3.py"))
    cfg.merge_from_dict({"total_epochs": epochs, "validate": False})
    cfg_noval = _write_config(cfg, os.path.join(root, "epochs2_noval.py"))
    n_k3 = sum(s["k3"] for s in train_sites)  # an eval forward's: road branch, with pose

    # Time checkpoint saves and restores where the CLI makes them.
    io_s = {"save": [], "restore": []}
    save0, restore0 = ckpt_mod.save_checkpoint, ckpt_mod.restore_checkpoint

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            io_s[key].append(time.perf_counter() - t0)
            return out
        return run

    ckpt_mod.save_checkpoint = timed(save0, "save")
    ckpt_mod.restore_checkpoint = timed(restore0, "restore")

    def cli(args, what):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = args()
        torch.cuda.synchronize()
        res["stages"][what] = {"seconds": time.perf_counter() - t0,
                               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        res["launches"][what] = kernels.launch_counts()
        return out

    def payloads(work_dir):
        return [json.loads(line) for f in sorted(glob.glob(os.path.join(work_dir, "*.log.json")))
                for line in open(f)]

    def expect_launches(what, n_steps, n_forwards):
        want = {k: v * n_steps for k, v in per_step.items()}
        want["conv3x3"] += n_k3 * n_forwards
        # An eval forward runs each CRP pool once; a step runs each backward once.
        want["maxpool5x5"] += per_step["maxpool5x5_bwd"] * n_forwards
        if res["launches"][what] != want:
            raise AssertionError(f"{what}: launches {res['launches'][what]}, expected {want} "
                                 f"({n_steps} steps, {n_forwards} eval forwards)")

    try:
        # 1. Train through the CLI.
        wd1 = os.path.join(root, "run")
        trainer = cli(lambda: train_cli.main(["--config", cfg2, "--work_dir", wd1, "--seed", "0",
                                              "--max_steps_per_epoch", str(steps)]), "train")
        n_val = len(trainer.eval_hook.loader.dataset)
        logs = payloads(wd1)
        modes = [(p["mode"], p["epoch"]) for p in logs]
        want_modes = [m for e in range(1, epochs + 1)
                      for m in (("train", e), ("val", e), ("epoch_time", e))]
        val_keys = set(DEPTH_KEYS) | {"road_iou", "road_map", "fps", "n_eval_samples"}
        vals = [p for p in logs if p["mode"] == "val"]
        if modes != want_modes or any(set(p) - {"mode", "epoch"} != val_keys for p in vals):
            raise AssertionError(f"train CLI payloads {logs}")
        if not all(math.isfinite(v) for p in vals for v in p.values() if not isinstance(v, str)):
            raise AssertionError(f"val metrics not finite: {vals}")
        if any(p["n_eval_samples"] != n_val for p in vals):
            raise AssertionError(f"n_eval_samples {[p['n_eval_samples'] for p in vals]}, "
                                 f"the validation set holds {n_val}")
        # fit_resilient saves the state it starts from first, then one an epoch.
        saved = sorted(os.listdir(os.path.join(wd1, "checkpoints")))
        if saved != [f"epoch_{e}.pth" for e in range(epochs + 1)]:
            raise AssertionError(f"checkpoints {saved}")
        if trainer.train_step.iteration != epochs * steps:
            raise AssertionError(f"iteration {trainer.train_step.iteration}")
        expect_launches("train", epochs * steps, epochs * n_val)
        res.update(val=vals, n_val=n_val, checkpoint_bytes=os.path.getsize(
            ckpt_mod.checkpoint_path(wd1, epochs)), train_payloads=logs,
            train_data_wait_s=trainer.data_wait_s)
        del trainer

        # 2. Resume through the CLI to one more epoch: the step holds the
        # saved state bit for bit when the loop starts.
        seen = {}
        fit0 = trainer_mod.Trainer.fit_resilient

        def fit_checked(self, total, work_dir, start_epoch=0, max_restarts=3):
            ck = torch.load(ckpt_mod.checkpoint_path(wd1, epochs), map_location="cpu",
                            weights_only=True)
            seen.update(start_epoch=start_epoch, iteration=self.train_step.iteration,
                        same=_same_state(torch, self.train_step, ck),
                        optimizer_state_dtypes=sorted({
                            str(v.dtype) for st in ck["optimizer"]["state"].values()
                            for v in st.values() if isinstance(v, torch.Tensor)}))
            return fit0(self, total, work_dir, start_epoch, max_restarts)

        trainer_mod.Trainer.fit_resilient = fit_checked
        wd2 = os.path.join(root, "resumed")
        try:
            trainer = cli(lambda: train_cli.main(["--config", cfg3, "--work_dir", wd2,
                                                  "--resume_from", wd1, "--seed", "0",
                                                  "--max_steps_per_epoch", str(steps)]), "resume")
        finally:
            trainer_mod.Trainer.fit_resilient = fit0
        if not (seen["start_epoch"] == epochs and seen["iteration"] == epochs * steps
                and seen["same"]):
            raise AssertionError(f"resume: {seen}")
        if not (os.path.isfile(ckpt_mod.checkpoint_path(wd2, epochs + 1))
                and trainer.train_step.iteration == (epochs + 1) * steps):
            raise AssertionError("resume: epoch 3's checkpoint or iteration missing")
        expect_launches("resume", steps, n_val)
        res["resume"] = seen
        del trainer

        # The same config uninterrupted for 3 epochs: the resumed run's
        # epoch-3 checkpoint equals its own, bit for bit (the step repeats
        # on the card, phase 14).
        wd_full = os.path.join(root, "uninterrupted")
        trainer = cli(lambda: train_cli.main(["--config", cfg3, "--work_dir", wd_full,
                                              "--seed", "0", "--max_steps_per_epoch",
                                              str(steps)]), "uninterrupted")
        expect_launches("uninterrupted", (epochs + 1) * steps, (epochs + 1) * n_val)
        del trainer
        res["resume"]["same_as_uninterrupted"] = same = _same_checkpoints(
            torch, ckpt_mod.checkpoint_path(wd2, epochs + 1),
            ckpt_mod.checkpoint_path(wd_full, epochs + 1))
        if not all(same.values()):
            raise AssertionError(f"resume: epoch 3's checkpoint differs from the uninterrupted "
                                 f"run's: {same}")

        # 3. fit_resilient: the loader fails once as epoch 2 starts; the run
        # restores the epoch-1 checkpoint and ends at iteration 8. A
        # TypeError is raised at once.
        wd3 = os.path.join(root, "restart")
        os.makedirs(os.path.join(wd3, "checkpoints"))
        shutil.copy(ckpt_mod.checkpoint_path(wd1, 1), ckpt_mod.checkpoint_path(wd3, 1))
        iter0 = loader_mod.DataLoader.__iter__
        begun = []

        def failing(exc, epoch):
            def it(self):
                begun.append(self.epoch)
                if begun.count(self.epoch) == 1 and self.epoch == epoch:
                    raise exc("loader failure injected by chip_smoke")
                return iter0(self)
            return it

        loader_mod.DataLoader.__iter__ = failing(RuntimeError, 1)
        try:
            trainer = cli(lambda: train_cli.main(["--config", cfg_noval, "--work_dir", wd3,
                                                  "--resume_from", wd3, "--seed", "0",
                                                  "--max_steps_per_epoch", str(steps)]),
                          "fit_resilient")
        finally:
            loader_mod.DataLoader.__iter__ = iter0
        restarts = [p for p in payloads(wd3) if p["mode"] == "restart"]
        if not (begun == [1, 1] and len(restarts) == 1 and restarts[0]["attempt"] == 1
                and trainer.train_step.iteration == epochs * steps):
            raise AssertionError(f"fit_resilient: epochs begun {begun}, restarts {restarts}, "
                                 f"iteration {trainer.train_step.iteration}")
        expect_launches("fit_resilient", steps, 0)
        del trainer
        same = _same_checkpoints(torch, ckpt_mod.checkpoint_path(wd3, epochs),
                                 ckpt_mod.checkpoint_path(wd_full, epochs))
        if not all(same.values()):
            raise AssertionError(f"fit_resilient: epoch 2's checkpoint differs from the "
                                 f"uninterrupted run's: {same}")
        begun.clear()
        loader_mod.DataLoader.__iter__ = failing(TypeError, 0)
        try:
            train_cli.main(["--config", cfg_noval, "--work_dir", os.path.join(root, "typeerror"),
                            "--seed", "0", "--max_steps_per_epoch", str(steps)])
            raise AssertionError("fit_resilient: a TypeError was retried or swallowed")
        except TypeError:
            pass
        finally:
            loader_mod.DataLoader.__iter__ = iter0
        if begun != [0] or any(p["mode"] == "restart"
                               for p in payloads(os.path.join(root, "typeerror"))):
            raise AssertionError(f"fit_resilient retried a TypeError: epochs begun {begun}")
        res["fit_resilient"] = {"restart": restarts[0], "same_as_uninterrupted": same}

        # 4. eval_depth on the epoch-2 checkpoint: the hook's depth row.
        row = cli(lambda: eval_depth.main(["--config", cfg2, "--checkpoint", wd1,
                                           "--epoch", str(epochs)]), "eval_depth")
        hook_row = [vals[-1][k] for k in eval_depth.METRICS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(row, hook_row))
        res["eval_depth"] = {"row": [float(v) for v in row], "hook_row": hook_row,
                             "max_rel_diff": rel}
        if not rel <= 1e-6:
            raise AssertionError(f"eval_depth {row} against the hook's {hook_row}")
        expect_launches("eval_depth", 0, n_val)

        # 5. Odometry over a 110-frame drive (one 100 m segment).
        seq_root, gt_dir, out = (os.path.join(root, d) for d in ("seq", "gt_pose", "odom"))
        t0 = time.perf_counter()
        render_odometry_sequence(seq_root, "21", gt_dir, 256, 110)
        res["stages"]["render_drive"] = {"seconds": time.perf_counter() - t0}
        plot = importlib.util.find_spec("matplotlib") is not None
        tool = draw_odometry.main if plot else draw_odometry.predict_and_score
        odom = cli(lambda: tool(["--config", cfg2, "--checkpoint", wd1, "--epoch", str(epochs),
                                 "--sequence", "21", "--gt_dir", gt_dir, "--out", out]),
                   "draw_odometry")
        poses = load_kitti_poses(os.path.join(out, "21.txt"))
        rot = poses[:, :3, :3]
        ortho = float(abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max())
        res["odometry"] = {k: v for k, v in odom.items()
                           if isinstance(v, (int, float)) and not isinstance(v, bool)}
        res["odometry"].update(pose_rows=len(poses), rotation_orthonormal_err=ortho,
                               matplotlib=plot)
        if not (len(poses) == 110 and ortho < 1e-2 and odom["n_segments"] >= 1
                and math.isfinite(odom["t_rel_percent"])
                and math.isfinite(odom["r_rel_deg_per_100m"])):
            raise AssertionError(f"odometry: {res['odometry']}")
    finally:
        ckpt_mod.save_checkpoint, ckpt_mod.restore_checkpoint = save0, restore0
        shutil.rmtree(root, ignore_errors=True)
    res["checkpoint_save_s"], res["checkpoint_restore_s"] = io_s["save"], io_s["restore"]
    log(f"workflow: {json.dumps({k: v for k, v in res.items() if k != 'train_payloads'})}")
    return res


# ---- Phase 13: the flagship preset from a KITTI file tree --------------------

# KITTI odometry's image size (H, W) by sequence.
KITTI_HW = {"00": (376, 1241), "01": (376, 1241), "02": (376, 1241), "03": (375, 1242)} | {
    s: (370, 1226) for s in ("04", "05", "06", "07", "08", "09", "10", "12")}
KITTI_TRAIN_LINES, KITTI_VAL_LINES = 12, 3
KITTI_ODOM_SEQ, KITTI_ODOM_FRAMES = "04", 271  # the packaged 04.txt's rows
# Sequence 00's raw drive date, whose calibration maps velodyne to camera 2.
KITTI_SEQ00_DATE = "2011_10_03"
KITTI_CALIB = ("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
               "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n"
               "P2: 718.856 0 607.1928 45.38225 0 718.856 185.2157 -0.1130887 0 0 1 0.003779761\n"
               "P3: 718.856 0 607.1928 -337.2877 0 718.856 185.2157 2.369057 0 0 1 0.004915215\n"
               "Tr: 0.0004276802 -0.9999672 -0.008084491 -0.01198459 -0.007210626 0.008081198 "
               "-0.9999413 -0.05403985 0.9999739 0.0004859485 -0.007206933 -0.2921968\n")


def _write_kitti_tree(pool, seqs: str, raw: str, train: list[str], val: list[str],
                      odom_seq: str, odom_frames: int) -> dict:
    """A KITTI odometry tree under `seqs`: for the split lines `train` and
    `val`, each line's frame and its -1/+1 neighbours as `image_2` PNGs at
    the sequence's KITTI size (a road scene of the simulated renderer,
    driven 1 m a frame, its far wall 60 m past the line's frame),
    `road_dense128` labels and a `calib.txt` a sequence, and for the `val`
    lines a velodyne scan of the ground ahead, with sequence 00's raw
    calibration under `raw`; and `odom_frames` frames of sequence
    `odom_seq` (the wall past the drive's end). Returns the files written
    by kind."""
    import numpy as np
    from PIL import Image

    from jperceiver_tpu_torch.data.simulated import STEP_M, _texture, render_frame, scene_calib

    tex_g = _texture(np.random.default_rng(12345))
    tex_w = _texture(np.random.default_rng(12345 + 31))
    jobs, labels, scans = [], 0, 0
    lbl = np.zeros((128, 128), np.uint8)
    lbl[:, 40:88] = 255  # the road straight ahead
    rng = np.random.default_rng(0)
    for line in train + val:
        seq, frame = line.split("/")[0], int(os.path.splitext(os.path.basename(line))[0])
        d = os.path.join(seqs, seq)
        for sub in ("image_2", "road_dense128", "velodyne"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        with open(os.path.join(d, "calib.txt"), "w") as f:
            f.write(KITTI_CALIB)
        for fr in (frame - 1, frame, frame + 1):
            jobs.append((os.path.join(d, "image_2", f"{fr:06d}.png"), KITTI_HW[seq],
                         fr * STEP_M, (frame + 60) * STEP_M))
            Image.fromarray(lbl).save(os.path.join(d, "road_dense128", f"{fr:06d}.png"))
            labels += 1
        if line in val:
            # Velodyne frame: x forward, y left, z up; the ground 1.73 m down.
            pts = np.zeros((20000, 4), np.float32)
            pts[:, 0] = rng.uniform(4, 70, len(pts))
            pts[:, 1] = rng.uniform(-12, 12, len(pts))
            pts[:, 2] = -1.73 + rng.normal(0, 0.02, len(pts))
            pts.tofile(os.path.join(d, "velodyne", f"{frame:06d}.bin"))
            scans += 1
    os.makedirs(os.path.join(raw, KITTI_SEQ00_DATE), exist_ok=True)
    with open(os.path.join(raw, KITTI_SEQ00_DATE, "calib_cam_to_cam.txt"), "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n"
                "P_rect_02: 718.856 0 607.1928 45.38225 0 718.856 185.2157 -0.1130887 0 0 1 "
                "0.003779761\nS_rect_02: 1241 376\n")
    with open(os.path.join(raw, KITTI_SEQ00_DATE, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 0 0\n")
    d = os.path.join(seqs, odom_seq, "image_2")
    os.makedirs(d, exist_ok=True)
    jobs += [(os.path.join(d, f"{i:06d}.png"), KITTI_HW[odom_seq], i * STEP_M,
              (odom_frames + 60) * STEP_M) for i in range(odom_frames)]

    def render(job):
        path, (h, w), cam_z, wall_z = job
        img, _ = render_frame(tex_g, tex_w, scene_calib(h, w)[0], h, w, cam_z=cam_z,
                              wall_z=wall_z)
        Image.fromarray((img * 255).astype(np.uint8)).save(path)

    list(pool.map(render, jobs))
    return {"images": len(jobs), "labels": labels, "velodyne": scans}


def phase_kitti(torch, card: str, per_step: dict, n_k3: int) -> dict:
    """Phase 13: the kitti_odom_1024 preset as a user runs it on KITTI's
    files. A KITTI odometry tree is written for the first 12 lines of the
    packaged `odometry/train_files.txt` (sequence 02) and the first 3 of
    `val_files.txt` (sequence 00, with velodyne scans and a raw-calibration
    date), PNGs at KITTI's sizes rendered by the simulated renderer. The
    preset is loaded with `Config.fromfile`; only `data.in_path`,
    `data.raw_calib_root`, the epochs and steps and bf16 compute are set,
    `data.split_dir` stays unset (the packaged lists). `get_dataset` reads
    the lists; the datasets are cut to the lines the tree holds. Then
    `Trainer.fit` for 2 epochs of 4 steps at B = 3 with validation (the
    eval hook, its depth row from velodyne), through the thread
    `DataLoader` at its defaults; the launches of each hand kernel against
    phase 9's a step and the eval forwards'; fit frames/s past start-up,
    the wait on the prefetch queue, a sample's decode and whole load (host
    clock), a profiled third epoch's idle share. Last `tools/draw_odometry`
    without `--gt_dir` on a 271-frame sequence 04 at 1226x370, scored
    against the packaged 04.txt."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from jperceiver_tpu_torch.config import Config
    from jperceiver_tpu_torch.data import DataLoader, get_dataset
    from jperceiver_tpu_torch.data.kitti import pil_open_rgb
    from jperceiver_tpu_torch.data.splits import default_split_dir, readlines, split_file
    from jperceiver_tpu_torch.engine import Trainer
    from jperceiver_tpu_torch.engine.eval_hook import DEPTH_KEYS, EvalHook
    from jperceiver_tpu_torch.evaluation.trajectory import load_kitti_poses
    from jperceiver_tpu_torch.models import build_model
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.tools import draw_odometry

    root = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    try:
        seqs, raw = os.path.join(root, "sequences"), os.path.join(root, "raw")
        cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                           "kitti_odom_1024.py"))
        steps, batch = 4, int(cfg.imgs_per_gpu)
        cfg.merge_from_dict({"data.in_path": seqs, "data.raw_calib_root": raw,
                             "model.compute_dtype": "bfloat16", "total_epochs": FIT_EPOCHS})
        if cfg.data.get("split_dir") is not None or batch != FIT_B:
            raise AssertionError("the preset sets a split_dir or another batch")
        split_dir = default_split_dir()
        lines = {t: readlines(split_file(split_dir, cfg.data.split, t))
                 for t in (True, False)}
        train_lines, val_lines = lines[True][:KITTI_TRAIN_LINES], lines[False][:KITTI_VAL_LINES]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            res["tree"] = _write_kitti_tree(pool, seqs, raw, train_lines, val_lines,
                                            KITTI_ODOM_SEQ, KITTI_ODOM_FRAMES)
        res["tree_s"] = time.perf_counter() - t0

        mcfg = cfg.model
        torch.manual_seed(0)
        model = build_model(mcfg)
        with_sdf, num_class = int(mcfg.loss_sum) >= 2, mcfg.num_class
        train_ds = get_dataset(cfg.data, training=True, with_sdf=with_sdf, num_class=num_class)
        val_ds = get_dataset(cfg.data, training=False, with_sdf=with_sdf, num_class=num_class)
        # The packaged lists, cut to the lines the tree holds.
        if not (train_ds.filenames == lines[True] and val_ds.filenames == lines[False]):
            raise AssertionError("get_dataset did not read the packaged odometry lists")
        res["packaged_lines"] = {"train": len(train_ds), "val": len(val_ds),
                                 "train_sequences": sorted({s.split("/")[0] for s in train_lines}),
                                 "val_sequences": sorted({s.split("/")[0] for s in val_lines})}
        train_ds.filenames, val_ds.filenames = train_lines, val_lines
        loader = DataLoader(train_ds, batch_size=batch, shuffle=True)
        val_loader = DataLoader(val_ds, batch_size=1, shuffle=False, drop_last=False)
        hook = EvalHook(model, val_loader, mcfg)
        logs = []
        trainer = Trainer(model, cfg, loader, steps, eval_hook=hook, log_fn=logs.append,
                          log_interval=steps)
        if len(loader) != steps:
            raise AssertionError(f"loader length {len(loader)}, expected {steps}")

        # The main path: counts set to 0 just before the fit, read just after.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(FIT_EPOCHS)
        torch.cuda.synchronize()
        res["fit_s"] = time.perf_counter() - t0
        res["launches"] = launches = kernels.launch_counts()
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        n_fwd = FIT_EPOCHS * len(val_lines)
        want = {k: v * FIT_EPOCHS * steps for k, v in per_step.items()}
        want["conv3x3"] += n_k3 * n_fwd
        want["maxpool5x5"] += per_step["maxpool5x5_bwd"] * n_fwd
        res["expected_launches"] = want
        if launches != want:
            raise AssertionError(f"kitti fit launches {launches}, expected {want} "
                                 f"({FIT_EPOCHS * steps} steps, {n_fwd} eval forwards)")

        trains = [p for p in logs if p["mode"] == "train"]
        vals = [p for p in logs if p["mode"] == "val"]
        res["payloads"] = logs
        if not (len(trains) == len(vals) == FIT_EPOCHS
                and all(math.isfinite(v) for p in trains for k, v in p.items()
                        if k not in ("mode", "epoch", "iter"))):
            raise AssertionError(f"kitti fit payloads {logs}")
        # The depth row from velodyne, over every validation sample.
        if not all(p["n_eval_samples"] == len(val_lines)
                   and all(math.isfinite(p[k]) for k in DEPTH_KEYS + ["road_iou"])
                   for p in vals):
            raise AssertionError(f"kitti validation {vals}")

        secs = [p["seconds"] for p in logs if p["mode"] == "epoch_time"]
        res["epochs"] = [{"seconds": t, "frames_per_s": steps * batch / t,
                          "data_wait_s": sum(w), "data_wait_first_batch_s": w[0],
                          "data_wait_steps_s": w}
                         for t, w in zip(secs, trainer.data_wait_s)]
        last = res["epochs"][-1]
        res["steady_frames_per_s"] = steps * batch / (last["seconds"]
                                                      - last["data_wait_first_batch_s"])
        waits = last["data_wait_steps_s"][1:]
        res["steady_data_wait_per_step_s"] = sum(waits) / len(waits)
        # The loader sets the pace where the loop waits for batches past
        # start-up for more than a tenth of the epoch.
        steady_s = last["seconds"] - last["data_wait_first_batch_s"]
        res["steady_data_wait_share"] = sum(waits) / steady_s
        res["loader_sets_pace"] = res["steady_data_wait_share"] > 0.1

        # One more epoch under the profiler, without validation: the idle share.
        trainer.eval_hook = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.fit(FIT_EPOCHS + 1, start_epoch=FIT_EPOCHS)
            torch.cuda.synchronize()
        dev = _device_events(prof)
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        span_ms = (max(e.time_range.end for e in dev)
                   - min(e.time_range.start for e in dev)) / 1e3
        res["profiled_epoch"] = {"device_busy_ms": busy_ms, "device_span_ms": span_ms,
                                 "idle_share": 1 - busy_ms / span_ms,
                                 "device_busy_ms_per_step": busy_ms / steps,
                                 "data_wait_s": sum(trainer.data_wait_s[-1])}

        # The loader's work a sample, on this thread (host clock): the PNG
        # decodes of its three frames and labels, and the whole sample
        # (decode, the resizes to KITTI's full size and to 1024^2, jitter,
        # the SDF labels).
        dec, whole = [], []
        for i, line in enumerate(train_lines):
            t0 = time.perf_counter()
            for off in (-1, 0, 1):
                pil_open_rgb(train_ds.image_path(line, off))
                pil_open_rgb(train_ds.label_path(line, off)).convert("L")
            dec.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            train_ds[i]
            whole.append(time.perf_counter() - t0)
        res["decode_ms_per_sample"] = 1e3 * float(np.median(dec))
        res["load_ms_per_sample"] = 1e3 * float(np.median(whole))

        # Odometry on sequence 04, scored against the packaged poses.
        ck = os.path.join(root, "weights.pth")
        torch.save({"state_dict": model.state_dict()}, ck)
        cfg_path = _write_config(cfg, os.path.join(root, "kitti_odom_1024.py"))
        del trainer, hook, model
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        odom = draw_odometry.predict_and_score(["--config", cfg_path, "--checkpoint", ck,
                                                "--sequence", KITTI_ODOM_SEQ,
                                                "--out", os.path.join(root, "odom")])
        torch.cuda.synchronize()
        odom_s = time.perf_counter() - t0
        poses = load_kitti_poses(os.path.join(root, "odom", f"{KITTI_ODOM_SEQ}.txt"))
        res["odometry"] = {k: v for k, v in odom.items()
                           if isinstance(v, (int, float)) and not isinstance(v, bool)}
        res["odometry"].update(pose_rows=len(poses), seconds=odom_s,
                               ms_per_frame=1e3 * odom_s / KITTI_ODOM_FRAMES,
                               launches=kernels.launch_counts())
        if not (len(poses) == odom["n_frames"] == KITTI_ODOM_FRAMES and odom["n_segments"] > 0
                and math.isfinite(odom["t_rel_percent"])
                and math.isfinite(odom["r_rel_deg_per_100m"])):
            raise AssertionError(f"kitti odometry: {res['odometry']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"kitti [{card}]: {json.dumps({k: v for k, v in res.items() if k != 'payloads'})}")
    return res


# ---- Phase 14: the training step repeats bit for bit -------------------------

# The environment of phase 14's child: cuBLAS's fixed workspace, which
# deterministic algorithms ask for, set before CUDA starts.
REPEAT_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# The port's repairs of the step's run-to-run difference, each of which
# `_formulations` can take back to the parent's formulation, with the
# autograd nodes of each, the parent's and the port's, as the profiler
# names their backward (`evaluate_function: <node>`).
REPAIR_NODES = {"reflect_pad": ("ReflectionPad2DBackward", "_ReflectPadBackward"),
                "resize_bilinear": ("UpsampleBilinear2DAaBackward", "_ResizeBilinearBackward"),
                "cct_gather": ("GatherBackward", "_GatherRowsBackward"),
                "cudnn_deterministic": ("ConvolutionBackward",)}
REPAIRS = tuple(REPAIR_NODES)


def _formulations(torch, parent: set):
    """Puts the operations named in `parent` back to the parent commit's
    formulation (CUDA's atomically adding backwards, cuDNN's own algorithm
    choice); returns a function that restores the port's."""
    import contextlib

    import torch.nn.functional as F

    from jperceiver_tpu_torch.engine import trainer
    from jperceiver_tpu_torch.losses import multitask
    from jperceiver_tpu_torch.models import common, jperceiver, layout_net

    class GatherRows:
        @staticmethod
        def apply(v, idx):
            return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[2]))

    def resize(img, out_h, out_w):
        return F.interpolate(img, size=(out_h, out_w), mode="bilinear", align_corners=False,
                             antialias=True)

    patches = {"reflect_pad": [(common, "reflect_pad",
                                lambda x, p=1: F.pad(x, (p, p, p, p), mode="reflect"))],
               "resize_bilinear": [(multitask, "resize_bilinear", resize),
                                   (jperceiver, "resize_bilinear", resize)],
               "cct_gather": [(layout_net, "_GatherRows", GatherRows)],
               "cudnn_deterministic": [(trainer, "deterministic_cudnn", contextlib.nullcontext)]}
    saved = []
    for name in parent:
        for mod, attr, fn in patches[name]:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)

    def restore():
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    return restore


def _grad_diffs(first: dict, second: dict) -> dict:
    """Where two runs' gradients differ: the count of parameters, and the
    modules by their largest difference (largest first, each with its
    parameters' scale)."""
    mods: dict = {}
    n = 0
    for k, a in first.items():
        d = (a - second[k]).abs().max().item()
        if d > 0 or not bool((a == second[k]).all()):
            n += 1
            m = mods.setdefault(k.rsplit(".", 1)[0], [0.0, 0.0])
            m[0] = max(m[0], d)
            m[1] = max(m[1], a.abs().max().item())
    worst = sorted(([d, m, s] for m, (d, s) in mods.items()), reverse=True)
    return {"params_differing": n, "n_params": len(first), "max_abs": worst[0][0] if worst else 0.0,
            "modules": worst[:12]}


def child_repeat(torch, d: str) -> dict:
    """Phase 14, in a child of its own (no global setting leaks into the
    other phases; cuBLAS's workspace set before CUDA starts): where the
    training step stops repeating bit for bit.
      1. Phase 8's fp32 step (1024^2, B = 1, road branch, kernels on, fp32
         reprojection operands) and the fit's step (the preset's model in
         fp32, B = 3, remat), each run twice from the same state: with the
         port's formulations, with the parent's, and with the parent's for
         one repaired operation at a time. Each pair's differing gradients
         by module. Phase 8's bf16 step, twice, with the port's.
      2. Device time of the bf16 step (phase 8's configuration, one
         profiled step after a warm one) with the parent's and the port's
         formulations in turns (parent, port, port, parent): busy time and
         each repaired operation's backward.
      3. Under `torch.use_deterministic_algorithms(True, warn_only=True)`,
         both steps twice with the parent's and with the port's
         formulations: the operations that warn (no deterministic
         implementation), and the pairs' differences."""
    import copy
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from jperceiver_tpu_torch import models
    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to

    res: dict = {"rank": 0, "env": {k: os.environ.get(k) for k in REPEAT_ENV}}
    b1 = batch_to(synthetic_batch(1, HW, HW, OCC, seed=0), "cuda")
    b3 = batch_to(synthetic_batch(FIT_B, HW, HW, OCC, seed=0), "cuda")
    flagship = {dt: build_model(torch, dt, "road") for dt in (torch.float32, torch.bfloat16)}
    init = {dt: copy.deepcopy(m.state_dict()) for dt, m in flagship.items()}
    torch.manual_seed(0)  # the fit's weights, as phase 11 makes them
    fit_weights = {k: v.detach().cpu().clone()
                   for k, v in models.build_model(_ddp_step_cfg(1).model).state_dict().items()}

    def flagship_step(dt):
        model = flagship[dt]
        model.load_state_dict(init[dt])
        cfg = TRAIN_CFG if dt == torch.bfloat16 else dict(
            TRAIN_CFG, use_pallas_reproj=True, pallas_reproj_bf16=False)
        # Eager (graph=False): the parent's formulations are compared op by op.
        step = make_train_step(model, cfg, seed=0, steps_per_epoch=STEPS_PER_EPOCH,
                               graph=False)
        models.set_kernels(model, True, True, True, stem_pool=True)
        return step

    def grads_of(step, batch):
        step(batch)
        return {n: p.grad.detach().clone() for n, p in step.model.named_parameters()
                if p.grad is not None}

    def pair(kind, parent):
        restore = _formulations(torch, parent)
        try:
            runs = []
            for _ in range(2):
                if kind == "fit_fp32":
                    runs.append(grads_of(_ddp_step(fit_weights, 1, True), b3))
                else:
                    dt = torch.float32 if kind == "flagship_fp32" else torch.bfloat16
                    runs.append(grads_of(flagship_step(dt), b1))
            torch.cuda.synchronize()
            return _grad_diffs(*runs)
        finally:
            restore()
            torch.cuda.empty_cache()

    variants = {"port": set(), "parent": set(REPAIRS)} | {
        f"parent_{r}_only": {r} for r in REPAIRS}
    t0 = time.perf_counter()
    res["default"] = {name: {kind: pair(kind, parent) for kind in ("flagship_fp32", "fit_fp32")}
                      for name, parent in variants.items()}
    res["default"]["port"]["flagship_bf16"] = pair("flagship_bf16", set())
    res["default_seconds"] = time.perf_counter() - t0

    # 2. Device time of the bf16 step, the parent's and the port's in turns.
    def profiled(parent):
        restore = _formulations(torch, parent)
        try:
            step = flagship_step(torch.bfloat16)
            step(b1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(b1)
                torch.cuda.synchronize()
        finally:
            restore()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if not getattr(e, "is_user_annotation", False)
                   and e.device_type.name == "CUDA") / 1e3
        nodes = {}
        for e in prof.key_averages():
            if e.key.startswith("autograd::engine::evaluate_function: "):
                us = getattr(e, "device_time_total", None)
                nodes[e.key.split(": ", 1)[1]] = (e.cuda_time_total if us is None else us) / 1e3
        ops = {r: sum(v for k, v in nodes.items() if any(k.startswith(n) for n in names))
               for r, names in REPAIR_NODES.items()}
        return {"device_busy_ms": busy, "repaired_ops_ms": ops,
                "top_backward_nodes_ms": dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:25])}

    turns = [("parent", profiled(set(REPAIRS))), ("port", profiled(set())),
             ("port", profiled(set())), ("parent", profiled(set(REPAIRS)))]
    busy = {v: [t["device_busy_ms"] for n, t in turns if n == v] for v in ("parent", "port")}
    res["device_time"] = {"turns": turns, "busy_ms": busy,
                          "port_over_parent": sum(busy["port"]) / sum(busy["parent"])}

    # 3. Deterministic algorithms, warnings collected.
    torch.use_deterministic_algorithms(True, warn_only=True)
    res["deterministic_algorithms"] = {}
    for name, parent in (("parent", set(REPAIRS)), ("port", set())):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            diffs = {kind: pair(kind, parent) for kind in ("flagship_fp32", "fit_fp32")}
        ops = Counter(str(w.message).split(" does not have a deterministic")[0]
                      for w in caught if "deterministic" in str(w.message))
        res["deterministic_algorithms"][name] = {"warned_ops": dict(ops), "diffs": diffs}
    torch.use_deterministic_algorithms(False)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def phase_repeat(torch, card: str) -> dict:
    """Phase 14: `child_repeat` in a child process; fails unless the port's
    fp32 and bf16 steps repeat bit for bit (every gradient of the second
    run equal to the first's)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_repeat_")
    t0 = time.perf_counter()
    try:
        (res,) = _run_children("repeat", root, 1, CHILD_TIMEOUT_S, REPEAT_ENV)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res.update(card=card, seconds=time.perf_counter() - t0)
    log(f"repeat [{card}]: {json.dumps(res)}")
    port = res["default"]["port"]
    if any(v["params_differing"] for v in port.values()):
        raise AssertionError(f"repeat: the port's step does not repeat bit for bit: {port}")
    return res


# ---- Phase 11: data parallel -------------------------------------------------

DDP_B = 3  # per rank: the preset's imgs_per_gpu
DDP_WORLD = 2
DDP_STEPS, DDP_EPOCHS, DDP_VAL = 4, 2, 13
DDP_C_EPOCHS = 7  # phase 11(c): 2 steps an epoch, past the captured step's 11 warm-ups
CHILD_TIMEOUT_S = 420


def _preset(overrides: dict):
    from jperceiver_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, "jperceiver_tpu_torch", "config", "presets",
                                       "kitti_odom_1024.py"))
    cfg.merge_from_dict(overrides)
    return cfg


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(role: str, d: str, world: int, timeout_s: float,
                  env_extra: dict | None = None, one_card_each: bool = False) -> list[dict]:
    """`world` ranks of `chip_smoke.py --child <role> <d>`, all on card 0
    (LOCAL_RANK 0: one process per host in torchrun's terms) or, with
    `one_card_each`, rank r on card r, each with a time limit and
    `env_extra` in its environment; a child that fails or hangs fails the
    phase. Returns each rank's `<d>/<role>_rank<r>.json`."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r if one_card_each else 0),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **(env_extra or {}))
        log_f = open(os.path.join(d, f"{role}_rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child",
                                        role, d], env=env, stdout=log_f,
                                       stderr=subprocess.STDOUT), log_f))
    t0 = time.perf_counter()
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        tails = []
        for r in range(world):
            with open(os.path.join(d, f"{role}_rank{r}.log")) as f:
                tails.append(f"rank {r}:\n{f.read()[-3000:]}")
        raise AssertionError(f"{role}: a child did not finish within {timeout_s} s "
                             "(a hung collective?)\n" + "\n".join(tails))
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode:
            with open(os.path.join(d, f"{role}_rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{role}: child (rank) {r} exited {p.returncode}:\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(d, f"{role}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _ddp_step_cfg(bn_groups: int):
    """Phase 11(a)'s step: the kitti_odom_1024 preset's model (1024^2, occ
    256, remat, road branch) in fp32, B = 3 a rank."""
    return _preset({"model.bn_groups": bn_groups, "model.compute_dtype": "float32"})


def _ddp_step(weights, bn_groups: int, on: bool, zero1: bool = False):
    """Phase 11(a)'s fp32 `TrainStep` from `weights`, with every kernel
    (`on`) or with cuDNN and the plain versions; eager (graph=False), as
    the data-parallel step is, and as phase 14 compares it."""
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.models import build_model, set_kernels

    cfg = _ddp_step_cfg(bn_groups)
    cfg.merge_from_dict({"model.use_pallas_reproj": on})
    model = build_model(cfg.model)
    model.load_state_dict(weights)
    step = make_train_step(model, cfg.model, steps_per_epoch=STEPS_PER_EPOCH, seed=0,
                           optim_cfg=cfg, zero1=zero1, graph=False)
    set_kernels(model, on, on, on, stem_pool=on)
    return step


# Queue 3 item 2: phase 11(a)'s step with one cross-rank reduction at a time
# swapped for a float64 one (the port's stay fp32, as the JAX package's psum).
F64_SWAPS = ("bn_moments", "denominators", "ddp_sum")
# (bn_groups, swap) of the two ranks' swapped steps: every swap at bn_groups
# 1; at 2, where no moment crosses the ranks, BatchNorm's moments alone
# (the loss denominators and DDP's sum are the same there).
F64_RUNS = tuple((1, swap) for swap in F64_SWAPS) + ((2, "bn_moments"),)
# The trunks whose gradients phase 11(a) moved most against their spread.
F64_TRUNKS = ("CycledViewProjection", "PoseEncoder")


def _bn_forward_f64(self, x):
    """`BatchNorm2d.forward` with the batch moments taken, and under a
    process group at bn_groups 1 all-reduced, in float64, then rounded to
    the statistics' dtype (the swap "bn_moments"; one process takes it too,
    over the global batch or its `groups` blocks)."""
    import torch

    from jperceiver_tpu_torch import parallel as dist

    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if not self.training:
        return self._normalize(xf, self.running_mean, self.running_var).to(x.dtype)
    distributed = dist.is_distributed()
    g = 1 if distributed else self.groups
    xd = xf.double().reshape(g, xf.shape[0] // g, *xf.shape[1:])
    stats = torch.stack([xd.mean((1, 3, 4)), (xd * xd).mean((1, 3, 4))], 1)
    if distributed and self.groups == 1:
        stats = dist.all_reduce_sum(stats) / dist.world_size()
    mean = stats[:, 0]
    var = torch.clamp_min(stats[:, 1] - mean * mean, 0.0)
    mean, var = mean.to(xf.dtype), var.to(xf.dtype)
    if self.update_stats:
        running = torch.stack([mean.mean(0), var.mean(0)]).detach()
        if distributed and self.groups > 1:
            running = dist.all_reduce_mean(running)
        self._update_running(running[0], running[1])
    y = self._normalize(xf.reshape(xd.shape), mean[:, None], var[:, None])
    return y.reshape(xf.shape).to(x.dtype)


def _f64_global_sum(x):
    """`parallel.global_sum` summed over the ranks in float64, rounded back
    (the swap "denominators"; the identity in one process)."""
    from jperceiver_tpu_torch import parallel as dist

    return dist.all_reduce_sum(x.detach().double()).to(x.dtype)


def _f64_sum_hook(state, bucket):
    """A DDP communication hook: the bucket summed over the ranks in
    float64, divided by the world size, rounded back (the swap "ddp_sum")."""
    import torch.distributed as tdist

    buf = bucket.buffer()

    def done(fut):
        value = fut.value()
        total = value[0] if isinstance(value, list) else value
        return buf.copy_(total / tdist.get_world_size())

    return tdist.all_reduce(buf.double(), async_op=True).get_future().then(done)


class _f64_swap:
    """Inside the block, `swap` ("bn_moments" or "denominators") takes its
    float64 form; "ddp_sum" is a hook on the step's DDP (`_f64_sum_hook`)."""

    def __init__(self, swap: str):
        self.swap, self.saved = swap, []

    def __enter__(self):
        import jperceiver_tpu_torch.ops.seg_losses as seg_losses
        import jperceiver_tpu_torch.parallel as par
        from jperceiver_tpu_torch.models.common import BatchNorm2d

        patch = {"bn_moments": [(BatchNorm2d, "forward", _bn_forward_f64)],
                 "denominators": [(par, "global_sum", _f64_global_sum),
                                  (seg_losses, "global_sum", _f64_global_sum)]}
        for obj, name, value in patch.get(self.swap, []):
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def child_step(torch, d: str) -> dict:
    """A rank of phase 11(a), over gloo on the one card, on its rows of the
    global batch: one fp32 step with the kernels for bn_groups 1 and 2
    (launches counted around it, the CCT argmax recorded), then three
    whole steps of the plain step and of the ZeRO-1 step from the same
    weights."""
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.parallel import init_distributed, rank

    init_distributed("gloo", timeout_s=CHILD_TIMEOUT_S)
    r = rank()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    local = {k: v[r * DDP_B:(r + 1) * DDP_B] for k, v in inp["batch"].items()}
    res = {"rank": r, "steps": {}}
    for g in (1, 2):
        step = _ddp_step(inp["weights"], g, True)
        probes = []
        hooks = cct_probe(torch, step.model, probes)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = step.reduce_metrics(step(local))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        torch.save([p[0].cpu() for p in probes], os.path.join(d, f"cct_bn{g}_rank{r}.pt"))
        res["steps"][g] = {"seconds": time.perf_counter() - t0,
                           "launches": kernels.launch_counts(),
                           "metrics": {k: float(v) for k, v in m.items()}}
        if r == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in step.model.named_parameters()},
                       os.path.join(d, f"grads_bn{g}.pt"))
        del step, m
        torch.cuda.empty_cache()
    # ZeRO-1 over three whole steps: the plain step and the ZeRO step, each
    # from the same weights, take their own three steps; each step's
    # gradients and the weights after the third are bit for bit the same
    # (the step repeats on the card, phase 14).
    off = _ddp_step(inp["weights"], 1, True)
    on = _ddp_step(inp["weights"], 1, True, zero1=True)
    t0 = time.perf_counter()
    grads = []
    for _ in range(3):
        off(local)
        grads.append([p.grad.clone() for p in off.params])
    for i in range(3):
        on(local)
        grads[i] = max(((p.grad - q).abs().max().item() for p, q in zip(on.params, grads[i])),
                       default=0.0)
    torch.cuda.synchronize()
    res["zero1_seconds"] = time.perf_counter() - t0
    res["zero1_step_grad_max_abs_diff"] = grads
    res["zero1_bit_for_bit"] = all(torch.equal(p, q) for p, q in zip(on.params, off.params))
    res["zero1_local_moment_elements"] = sum(
        v.numel() for st in on.optimizer.optim.state.values()
        for k, v in st.items() if k in ("mu", "nu")) // 2
    res["param_elements"] = sum(p.numel() for p in on.params)
    del off, on, grads
    torch.cuda.empty_cache()
    # Queue 3 item 2: one step (bn_groups 1) with each cross-rank reduction
    # swapped for a float64 one, one at a time.
    res["f64_swaps"] = {}
    for g, swap in F64_RUNS:
        with _f64_swap(swap):
            step = _ddp_step(inp["weights"], g, True)
            if swap == "ddp_sum":
                step.ddp.register_comm_hook(None, _f64_sum_hook)
            t0 = time.perf_counter()
            m = step.reduce_metrics(step(local))
            torch.cuda.synchronize()
        res["f64_swaps"][f"{swap}_bn{g}"] = {"seconds": time.perf_counter() - t0,
                                             "loss": float(m["loss"])}
        if r == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in step.model.named_parameters()},
                       os.path.join(d, f"grads_{swap}_bn{g}.pt"))
        del step, m
        torch.cuda.empty_cache()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def child_cli(torch, d: str) -> dict:
    """A rank of phase 11(b)/(c): `tools/train.py main(argv)` as torchrun
    would start it, the validation set cut to `val_scenes` simulated scenes
    (the factory takes one scene count for both sets), recording the files
    this rank opened for writing under the work dir."""
    import builtins

    import jperceiver_tpu_torch.data as data_mod
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.tools import train as train_cli

    with open(os.path.join(d, "cli_args.json")) as f:
        args = json.load(f)
    work = args["work_dir"]
    get0 = data_mod.get_dataset

    def get_dataset(cfg, training=True, **kw):
        ds = get0(cfg, training=training, **kw)
        if not training:
            ds.n_scenes = args["val_scenes"]
        return ds

    wrote = []
    open0, save0 = builtins.open, torch.save

    def open_rec(file, mode="r", *a, **k):
        if any(c in mode for c in "wax") and str(file).startswith(work):
            wrote.append(os.path.relpath(str(file), work))
        return open0(file, mode, *a, **k)

    def save_rec(obj, f, *a, **k):
        wrote.append(os.path.relpath(str(f), work))
        return save0(obj, f, *a, **k)

    data_mod.get_dataset = get_dataset
    builtins.open, torch.save = open_rec, save_rec
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main(args["argv"])
        torch.cuda.synchronize()
    finally:
        builtins.open, torch.save = open0, save0
        data_mod.get_dataset = get0
    dist = torch.distributed
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": str(dist.get_backend()), "seconds": time.perf_counter() - t0,
            "launches": kernels.launch_counts(), "wrote": sorted(set(wrote)),
            "iteration": trainer.train_step.iteration,
            "n_val_batches": len(trainer.eval_hook.loader), "device": str(trainer.device),
            "graphed": trainer.train_step.graphed,
            "captures": trainer.train_step.graphs.captures,
            "eval_captures": trainer.eval_hook.eval_step.graphs.captures,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def child_main(role: str, d: str) -> int:
    import faulthandler

    import torch

    # A child that hangs writes every thread's stack to its log before the
    # parent's time limit kills it.
    faulthandler.dump_traceback_later(CHILD_TIMEOUT_S - 30, exit=False)

    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"step": child_step, "cli": child_cli, "repeat": child_repeat,
           "ddp_graph": child_ddp_graph}[role](torch, d)
    with open(os.path.join(d, f"{role}_rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def phase_ddp(torch, card: str, per_step: dict, n_k3: int) -> dict:
    """Phase 11: data parallel at the kitti_odom_1024 preset's model
    (1024^2, occ 256, remat, road branch), B = 3 a rank. The kernels are
    built (phase 1) before any child starts.
      (a) two ranks over gloo on the one card, fp32, kernels on: one step
          for bn_groups 1 and 2 against one process at B = 6 from the same
          weights, batch and generator seed (so the same dropout and
          automask draws): losses within rtol 1e-4; each trunk's averaged
          gradient (L2 over its parameters) within 3x the one-process
          step's own spread plus 1e-3 of its norm, the spread being the
          largest of its distances between kernels on and off and under
          two rounding-level changes of the input pixels (x (1 + 2^-22 u),
          u uniform in [-1, 1]); each parameter's max-abs distances and the
          CCT argmax flips are logged; each rank's launches in the step
          phase 9's a step; over three whole steps, the ZeRO-1 step bit
          for bit the plain step (each step's gradients, the weights after
          the third), each rank holding about half of Adam's moments;
      (b) two ranks of `tools/train.py --launcher pytorch --dist_backend
          gloo`, bf16, 2 epochs of 4 steps, validation on 13 scenes: each
          rank's launches those of its 8 steps and 7 eval forwards an epoch,
          rank 0 alone writing checkpoints and the log, n_eval_samples 13,
          finite losses;
      (c) one rank of the same CLI on its default backend (NCCL), 7 epochs
          of 2 steps, validation on 3 scenes, checkpoints at the start and
          the end: the step captured once, at its 12th, past DDP's 11
          eager warm-ups.
    (a) also runs one step with each cross-rank reduction swapped for a
    float64 one (`F64_SWAPS`, ROADMAP queue 3 item 2): logged, and with
    BatchNorm's moments in float64 (one process too) every parameter
    within the per-parameter bound, the gate the fp32 step cannot meet.
    Two ranks on one card give no throughput: their times are logged as
    times, beside the card's name and power limit."""
    import shutil
    import tempfile

    import numpy as np

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.models import build_model

    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    try:
        # (a) The one-process references at the global batch.
        torch.manual_seed(0)
        model = build_model(_ddp_step_cfg(1).model)
        weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        batch = synthetic_batch(DDP_WORLD * DDP_B, HW, HW, OCC, seed=0)
        d_a = os.path.join(root, "step")
        os.makedirs(d_a)
        torch.save({"weights": weights, "batch": batch}, os.path.join(d_a, "inputs.pt"))
        # Per bn_groups: kernels on, off, and on with each input pixel moved
        # by a rounding-level amount (x (1 + 2^-22 u), u uniform in [-1, 1],
        # two draws): how far the one-process step itself moves under a
        # change of rounding, which is what two ranks are (other reduction
        # orders, other library kernels at B = 3). A uniform scale of the
        # input would not do: the first BatchNorm takes it out.
        refs = {}
        nudge = np.random.default_rng(1)
        for g in (1, 2):
            for name, on in (("on", True), ("off", False), ("on~1", True), ("on~2", True)):
                step = _ddp_step(weights, g, on)
                u = (nudge.uniform(-1, 1, batch["color_aug"].shape) if name.startswith("on~")
                     else 0.0)
                b = dict(batch, color_aug=(batch["color_aug"] * (1 + 2.0 ** -22 * u))
                         .astype(batch["color_aug"].dtype))
                probes = []
                hooks = cct_probe(torch, step.model, probes)
                m = step(b)
                for h in hooks:
                    h.remove()
                refs[g, name] = ({kk: float(v) for kk, v in m.items()},
                                 {n: p.grad.detach().cpu()
                                  for n, p in step.model.named_parameters()},
                                 [p[0].cpu() for p in probes])
                del step, m
        # Queue 3 item 2: the one-process step with BatchNorm's moments in
        # float64, the reference of the two ranks' "bn_moments" swap (the
        # other swaps are the identity in one process).
        for g in (1, 2):
            with _f64_swap("bn_moments"):
                step = _ddp_step(weights, g, True)
                step(batch)
                refs[g, "bn_moments"] = (None, {n: p.grad.detach().cpu()
                                                for n, p in step.model.named_parameters()}, None)
                del step
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _run_children("step", d_a, DDP_WORLD, CHILD_TIMEOUT_S)
        res["a_seconds"] = time.perf_counter() - t0
        res["a"] = {"ranks": ranks, "bn_groups": {}}
        for g in (1, 2):
            got = torch.load(os.path.join(d_a, f"grads_bn{g}.pt"), weights_only=True)
            (m_on, g_on, p_on), (_, g_off, _) = refs[g, "on"], refs[g, "off"]
            # CCT hard-attention argmax flips against the one-process step.
            p_ddp = [torch.cat(t) for t in zip(*(
                torch.load(os.path.join(d_a, f"cct_bn{g}_rank{r}.pt"), weights_only=True)
                for r in range(DDP_WORLD)))]
            flips = {name: sum(int((a != b).sum()) for a, b in zip(p_on, refs[g, name][2]))
                     for name in ("off", "on~1", "on~2")}
            flips["ddp"] = sum(int((a != b).sum()) for a, b in zip(p_on, p_ddp))
            m_ddp = ranks[0]["steps"][str(g)]["metrics"]
            loss_rel = {k: abs(m_ddp[k] - w) / abs(w) for k, w in m_on.items() if k != "grad_norm"}
            # Per trunk (a child of the model): the L2 distance of the two
            # ranks' gradients to the one-process step's within 3x the
            # step's own spread (its distance under kernels off, or under
            # either input nudge) plus 1e-3 of the trunk's gradient norm.
            # Per parameter, the same distances in max-abs are logged, with
            # the bound the issue set (3x the on/off distance + 1e-3 of the
            # parameter's scale).
            pert = ("off", "on~1", "on~2")
            rows, trunks = [], {}
            for n, ref in g_on.items():
                t = trunks.setdefault(n.split(".")[0], dict.fromkeys(("ddp", "norm") + pert, 0.0))
                d = got[n] - ref
                t["ddp"] += float((d * d).sum())
                t["norm"] += float((ref * ref).sum())
                dev = {}
                for k in pert:
                    dk = refs[g, k][1][n] - ref
                    t[k] += float((dk * dk).sum())
                    dev[k] = dk.abs().max().item()
                e, scale = d.abs().max().item(), ref.abs().max().item()
                b_issue = 3 * dev["off"] + 1e-3 * scale
                b_all = 3 * max(dev.values()) + 1e-3 * scale
                rows.append([e / b_all if b_all else 0.0, n, e, dev, scale,
                             e / b_issue if b_issue else 0.0])
            rows.sort(reverse=True)
            trunk_rows = []
            for name, t in trunks.items():
                spread, norm, dist = (max(math.sqrt(t[k]) for k in pert), math.sqrt(t["norm"]),
                                      math.sqrt(t["ddp"]))
                bound = 3 * spread + 1e-3 * norm
                trunk_rows.append([dist / bound if bound else (math.inf if dist else 0.0), name,
                                   dist, spread, norm])
            trunk_rows.sort(reverse=True)
            issue = sorted(((r[5], r[1]) for r in rows), reverse=True)
            res["a"]["bn_groups"][g] = {
                "loss_rel_max": max(loss_rel.values()), "worst_trunks": trunk_rows[:5],
                "worst_params": rows[:5], "cct_argmax_flips": flips,
                "issue_bound": {"over": sum(r[0] > 1.0 for r in issue), "worst": issue[:4]},
                "grad_norm": {"ddp": m_ddp["grad_norm"], "one_process": m_on["grad_norm"]},
                "step_seconds": [r["steps"][str(g)]["seconds"] for r in ranks]}
            if max(loss_rel.values()) > 1e-4 or trunk_rows[0][0] > 1.0:
                raise AssertionError(f"ddp (a) bn_groups {g}: losses {loss_rel}, worst trunks "
                                     f"{trunk_rows[:4]}, worst parameters {rows[:4]}")
        for r in ranks:
            for g in ("1", "2"):
                if r["steps"][g]["launches"] != per_step:
                    raise AssertionError(f"ddp (a) rank {r['rank']} bn_groups {g} launches "
                                         f"{r['steps'][g]['launches']}, expected {per_step}")
            share = r["zero1_local_moment_elements"] / r["param_elements"]
            if not (r["zero1_bit_for_bit"] and not any(r["zero1_step_grad_max_abs_diff"])
                    and 0.45 <= share <= 0.55):
                raise AssertionError(f"ddp (a) ZeRO-1 on rank {r['rank']}: weights bit for bit "
                                     f"{r['zero1_bit_for_bit']}, gradient differences a step "
                                     f"{r['zero1_step_grad_max_abs_diff']}, moment share {share}")
        if sum(r["zero1_local_moment_elements"] for r in ranks) != ranks[0]["param_elements"]:
            raise AssertionError("ddp (a) ZeRO-1: the ranks' moments do not add up to the model")
        # Queue 3 item 2: with BatchNorm's moments in float64 on both sides
        # every parameter is within the per-parameter bound, so the
        # fp32 moments' rounding is what moved the default step's: gated.
        swaps = res["a"]["f64_swaps"] = _f64_swap_readings(torch, d_a, refs)
        for g in (1, 2):
            if swaps[f"bn_moments_bn{g}"]["params_over_bound"]:
                raise AssertionError(f"ddp (a) bn_groups {g} with BatchNorm's moments in "
                                     f"float64: {swaps[f'bn_moments_bn{g}']}")
        log(f"ddp (a) [{card}]: {json.dumps({k: v for k, v in res['a'].items()})}")

        # (b), (c): the train CLI, as torchrun starts it.
        def cli(name, world, scenes, epochs, val, backend, ckpt_interval=1):
            d = os.path.join(root, name)
            os.makedirs(d)
            work = os.path.join(d, "work")
            cfg = _preset({"data.name": "simulated", "data.n_scenes": scenes,
                           "model.compute_dtype": "bfloat16", "total_epochs": epochs,
                           "log_config.interval": scenes // (world * DDP_B),
                           "checkpoint_config.interval": ckpt_interval})
            cfg_path = _write_config(cfg, os.path.join(d, "cfg.py"))
            argv = ["--config", cfg_path, "--work_dir", work, "--seed", "0",
                    "--launcher", "pytorch"] + (["--dist_backend", backend] if backend else [])
            with open(os.path.join(d, "cli_args.json"), "w") as f:
                json.dump({"argv": argv, "work_dir": work, "val_scenes": val}, f)
            t0 = time.perf_counter()
            out = _run_children("cli", d, world, CHILD_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            logs = [json.loads(line) for fn in sorted(os.listdir(work))
                    if fn.endswith(".log.json") for line in open(os.path.join(work, fn))]
            return out, logs, seconds

        n_steps = DDP_STEPS * DDP_EPOCHS
        b, logs, secs = cli("b", DDP_WORLD, DDP_WORLD * DDP_B * DDP_STEPS, DDP_EPOCHS, DDP_VAL,
                            "gloo")
        n_fwd = -(-DDP_VAL // DDP_WORLD) * DDP_EPOCHS  # 7 a rank an epoch, the tail padded
        res["b"] = {"seconds": secs, "ranks": b, "payloads": logs}
        _check_cli(b, logs, per_step, n_k3, n_steps, n_fwd, DDP_EPOCHS, DDP_VAL, "gloo", "b",
                   captures=0)
        log(f"ddp (b) [{card}]: {secs:.1f} s, ranks "
            f"{[{k: r[k] for k in ('seconds', 'iteration', 'peak_memory_gb')} for r in b]}")

        # (c) past the captured step's warm-ups: 7 epochs of 2 steps,
        # the step captured at its 12th, a checkpoint at the start and the end.
        c, logs, secs = cli("c", 1, DDP_B * 2, DDP_C_EPOCHS, 3, None, DDP_C_EPOCHS)
        res["c"] = {"seconds": secs, "ranks": c, "payloads": logs}
        _check_cli(c, logs, per_step, n_k3, 2 * DDP_C_EPOCHS, 3 * DDP_C_EPOCHS, DDP_C_EPOCHS, 3,
                   "nccl", "c", ckpt_epochs=(0, DDP_C_EPOCHS), captures=1)
        log(f"ddp (c) [{card}]: {secs:.1f} s, {c[0]['backend']}, "
            f"{c[0]['seconds']:.1f} s in the rank, step captures {c[0]['captures']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _f64_swap_readings(torch, d: str, refs: dict) -> dict:
    """Queue 3 item 2's readings: for each run of `F64_RUNS` and the
    unswapped steps, the two ranks' gradient against the one-process step
    at the same bn_groups with the same swap, per trunk of `F64_TRUNKS` (L2
    over its parameters) against the one-process spread (the largest of
    kernels off and the two input nudges), and over every parameter how
    many exceed the per-parameter bound (3x the on/off distance + 1e-3 of
    the parameter's scale), with the worst ratios."""
    pert = ("off", "on~1", "on~2")
    runs = {f"unswapped_bn{g}": (g, f"grads_bn{g}.pt", refs[g, "on"][1]) for g in (1, 2)}
    for g, swap in F64_RUNS:
        runs[f"{swap}_bn{g}"] = (g, f"grads_{swap}_bn{g}.pt",
                                 refs[g, swap][1] if swap == "bn_moments" else refs[g, "on"][1])
    out = {}
    for name, (g, fname, ref) in runs.items():
        got = torch.load(os.path.join(d, fname), weights_only=True)
        g_on = refs[g, "on"][1]
        trunks = {}
        for trunk in F64_TRUNKS:
            names = [n for n in ref if n.split(".")[0] == trunk]
            dist = math.sqrt(sum(float(((got[n] - ref[n]) ** 2).sum()) for n in names))
            spread = max(math.sqrt(sum(float(((refs[g, k][1][n] - g_on[n]) ** 2).sum())
                                       for n in names)) for k in pert)
            trunks[trunk] = {"distance": dist, "spread": spread,
                             "ratio": dist / spread if spread else math.inf}
        ratios = []
        for n, r in ref.items():
            bound = 3 * (refs[g, "off"][1][n] - g_on[n]).abs().max().item() \
                + 1e-3 * g_on[n].abs().max().item()
            e = (got[n] - r).abs().max().item()
            ratios.append([e / bound if bound else (math.inf if e else 0.0), n])
        ratios.sort(reverse=True)
        out[name] = {"trunks": trunks, "params_over_bound": sum(q > 1 for q, _ in ratios),
                     "worst": ratios[:3]}
    return out


def _check_cli(ranks, logs, per_step, n_k3, n_steps, n_fwd, epochs, n_val, backend, what,
               ckpt_epochs=None, captures=0):
    """Phase 11(b)/(c): every rank's launches, iteration, backend and step
    captures (gloo: none; NCCL: one, past the warm-ups); rank 0 alone wrote
    the checkpoints (the start's and one at each of `ckpt_epochs`, default
    every epoch) and the log; the val payloads count every validation
    sample once; finite losses."""
    want = {k: v * n_steps for k, v in per_step.items()}
    want["conv3x3"] += n_k3 * n_fwd
    want["maxpool5x5"] += per_step["maxpool5x5_bwd"] * n_fwd
    ckpts = [os.path.join("checkpoints", f"epoch_{e}.pth.tmp")
             for e in (range(epochs + 1) if ckpt_epochs is None else ckpt_epochs)]
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"ddp ({what}) rank {r['rank']} launches {r['launches']}, "
                                 f"expected {want}")
        if (r["iteration"] != n_steps or r["backend"] != backend
                or (r["graphed"], r["captures"]) != (captures > 0, captures)):
            raise AssertionError(f"ddp ({what}) rank {r['rank']}: iteration {r['iteration']}, "
                                 f"backend {r['backend']}, graphed {r['graphed']}, step "
                                 f"captures {r['captures']}")
        wrote = r["wrote"]
        if r["rank"] == 0:
            if ([w for w in wrote if w.startswith("checkpoints")] != ckpts
                    or sum(w.endswith(".log.json") for w in wrote) != 1):
                raise AssertionError(f"ddp ({what}) rank 0 wrote {wrote}")
        elif wrote:
            raise AssertionError(f"ddp ({what}) rank {r['rank']} wrote {wrote}")
    vals = [p for p in logs if p["mode"] == "val"]
    trains = [p for p in logs if p["mode"] == "train"]
    if [p["n_eval_samples"] for p in vals] != [n_val] * epochs:
        raise AssertionError(f"ddp ({what}) val payloads {vals}")
    if len(trains) != epochs or not all(math.isfinite(p["loss"]) for p in trains):
        raise AssertionError(f"ddp ({what}) train payloads {trains}")


def phase_tools(torch, card: str) -> dict:
    """Phase 12: `tools/profile_step.py` for 5 steps of the 1024^2 bf16
    flagship step, `tools/trace_summary.py` on its trace (K1-K5 and both
    pool backwards by name, with device time), and `tools/complexity.py`
    at 1024^2 (its parameter total the model's). The tools print to
    stderr here."""
    import contextlib
    import shutil
    import tempfile

    from jperceiver_tpu_torch.models import JPerceiver
    from jperceiver_tpu_torch.tools import complexity, profile_step, trace_summary

    root = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    res: dict = {"card": card}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            prof = profile_step.main(["--out", root, "--steps", "5"])
            res["profile_step_s"] = time.perf_counter() - t0
            summary = trace_summary.main([root, "--steps", "5", "--top", "25"])
            t0 = time.perf_counter()
            cx = complexity.main(["--height", str(HW), "--width", str(HW)])
            res["complexity_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    names = {"K1": "reproj_fwd", "K2": "reproj_bwd", "K3": "conv3x3_bf16",
             "K4": "wgrad_bf16", "K5": "maxpool5x5_nhwc", "K5-bwd": "maxpool5x5_bwd_nhwc",
             "stem-pool-bwd": "maxpool3x3s2_bwd"}
    found = {kid: {"ms_per_step": sum(v["us"] for n, v in summary["kernels"].items()
                                      if sub in n) / 5 / 1e3,
                   "per_step": sum(v["count"] for n, v in summary["kernels"].items()
                                   if sub in n) / 5}
             for kid, sub in names.items()}
    res.update(ms_per_step=prof["ms_per_step"], track=summary["track"],
               device_ms_per_step=summary["total_ms_per_step"],
               kernels_per_step=summary["ops_per_step"], hand_kernels=found,
               complexity_params=cx["total_params"], complexity_gflops=cx["total_flops"] / 1e9)
    if summary["track"] != "kernel" or not all(v["ms_per_step"] > 0 for v in found.values()):
        raise AssertionError(f"trace_summary: track {summary['track']}, hand kernels {found}")
    with torch.device("meta"):
        n_model = sum(p.numel() for p in JPerceiver(occ_map_size=OCC).parameters())
    if cx["total_params"] != n_model:
        raise AssertionError(f"complexity: {cx['total_params']} parameters, the model "
                             f"{n_model}")
    log(f"tools [{card}]: {json.dumps(res)}")
    return res


# ---- Phase 15: the entry points as CUDA graphs --------------------------------

def _prof_counts(torch, prof) -> dict:
    """Each hand kernel's launches in a profiler trace, by kernel name, with
    the trace's device busy time, span and idle share."""
    dev = _device_events(prof)
    names = Counter(e.name for e in dev)
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span_ms = ((max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
               if dev else 0.0)

    def count(sub):
        return sum(n for k, n in names.items() if sub in k)

    return {"k1": count("reproj_fwd"), "k2": count("reproj_bwd"), "k3": count("conv3x3_bf16"),
            "k4": count("wgrad_bf16"), "k5": count("maxpool5x5_nhwc"),
            "k5_bwd": count("maxpool5x5_bwd_nhwc"), "stem_pool_bwd": count("maxpool3x3s2_bwd"),
            "device_events": sum(names.values()), "device_busy_ms": busy_ms,
            "device_span_ms": span_ms,
            "idle_share": 1 - busy_ms / span_ms if span_ms else None}


def _counters_as_profiled(counts: dict) -> dict:
    """`launch_counts()` in the profiler's kernels (K3's forward and
    data-grad are one kernel)."""
    return {"k1": counts["reproj_fwd"], "k2": counts["reproj_bwd"],
            "k3": counts["conv3x3"] + counts["conv3x3_dgrad"], "k4": counts["conv3x3_wgrad"],
            "k5": counts["maxpool5x5"], "k5_bwd": counts["maxpool5x5_bwd"],
            "stem_pool_bwd": counts["maxpool3x3s2_bwd"]}


_KERNEL_KEYS = ("k1", "k2", "k3", "k4", "k5", "k5_bwd", "stem_pool_bwd")


def _snapshot(step, metrics) -> dict:
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": [None if p.grad is None else p.grad.clone() for p in step.params],
            "params": [p.detach().clone() for p in step.params]}


def _final_state(step) -> dict:
    return {"model": {k: v.clone() for k, v in step.model.state_dict().items()},
            "optimizer": [{k: v.clone() for k, v in st.items()} for st in
                          getattr(step.optimizer, "optim", step.optimizer).state.values()],
            "generator": step.generator.get_state(), "iteration": step.iteration}


def _captured_vs_eager(torch, make_step, batches, what: str) -> dict:
    """`make_step(graph)` twice from the same state: the eager step and the
    captured one (its first step eager, its second captured and replayed,
    the rest replays), over `batches`. Raises unless every step's metrics,
    gradients and weights, and the final model (BatchNorm statistics
    included), Adam state, generator and iteration are bit for bit equal.
    Returns each run's peak memory, each step's seconds (synchronised
    before and after it, the snapshots outside) and the capture's seconds,
    and the captured step itself."""
    runs = {}
    for graph in (False, None):
        step = make_step(graph)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        snaps, lrs, secs = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            snaps.append(_snapshot(step, m))
            lrs.append(float(step.optimizer.param_groups[0]["lr"]))
        torch.cuda.synchronize()
        runs[graph] = {"snaps": snaps, "final": _final_state(step), "lrs": lrs, "step": step,
                       "step_s": secs,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if graph is False:
            del step
    eager, capt = runs[False], runs[None]
    differing = [f"step {i + 1} {part}" for i, (a, b) in enumerate(zip(eager["snaps"],
                                                                          capt["snaps"]))
                 for part in a if not _same(torch, a[part], b[part])]
    differing += [f"final {part}" for part in eager["final"]
                  if not _same(torch, eager["final"][part], capt["final"][part])]
    step = capt["step"]
    res = {"steps": len(batches), "lrs": capt["lrs"], "eager_lrs": eager["lrs"],
           "losses": [float(s["metrics"]["loss"]) for s in capt["snaps"]],
           "grad_norms": [float(s["metrics"]["grad_norm"]) for s in capt["snaps"]],
           "captures": step.graphs.captures, "capture_s": step.graphs.capture_s,
           "step_s": {"eager": eager["step_s"], "captured": capt["step_s"]},
           "peak_memory_gb": {"eager": eager["peak_memory_gb"],
                              "captured": capt["peak_memory_gb"]},
           "differing": differing}
    log(f"graph {what}: {json.dumps(res)}")
    if differing or step.graphs.captures != 1 or not step.graphed:
        raise AssertionError(f"{what}: the captured step is not the eager step bit for bit: "
                             f"{res}")
    return res, step


def phase_graph(torch, card: str, per_step: dict, n_k3_train: int, ft: dict,
                kitti: dict) -> dict:
    """Phase 15: the entry points as CUDA graphs (`engine/graphs.py`), each
    against its eager twin (graph=False), at 1024^2, occ 256.
      (a) phase 8's step (B = 1, road branch, Adam, clip 35), fp32 and bf16,
          3 steps each from one state and generator (dropout and the
          automask noise drawn), the LR milestone between steps 2 and 3;
      (b) the fit's step (kitti_odom_1024: B = 3, remat, bf16), 3 steps;
      (c) the eval step at B = 1 and streaming over 10 frames in chunks of
          4 (4, 4, then 1), each call's outputs; `linalg.inv_ex` against
          `linalg.inv` at the CGT's matrices;
      all bit for bit;
      (d) each hand kernel's launches in a profiled replay, by kernel name,
          equal to the eager step's counters and to phase 8's and 9's tables,
          and `launch_counts()` of the replay equal to the profiler's;
      (e) a forward that calls `.item()`, captured, raises;
      (f) times (not gated): train frames/s and eval latency captured and
          eager in turns, streaming frames/s, the idle share and busy time
          of a profiled replay, the captures' seconds and peak memory, and
          phases 9 and 13 (captured fits) beside phase 9's eager twin."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_eval_step, make_streaming_fn, make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to
    from jperceiver_tpu_torch.losses.cgt import _shifted_ground_from_img
    from jperceiver_tpu_torch.models import build_model as build_preset_model
    from jperceiver_tpu_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    res: dict = {"card": card}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def profiled(step, batch) -> dict:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=acts) as prof:
            step(batch)
            torch.cuda.synchronize()
        out = _prof_counts(torch, prof)
        out["counters"] = _counters_as_profiled(kernels.launch_counts())
        return out

    # (a) Phase 8's step, the LR milestone at iteration 2 (epoch 1 of 2 steps).
    cfg_a = dict(TRAIN_CFG, lr_config=dict(policy="step", warmup=None, step=[1]))
    b1 = [batch_to(synthetic_batch(1, HW, HW, OCC, seed=s), "cuda") for s in range(3)]
    for name, dtype, extra in (("fp32", torch.float32, dict(use_pallas_reproj=True,
                                                             pallas_reproj_bf16=False)),
                               ("bf16", torch.bfloat16, {})):
        model = build_model(torch, dtype, "road")
        init = copy.deepcopy(model.state_dict())

        def make(graph, model=model, init=init, extra=extra):
            model.load_state_dict(init)
            return make_train_step(model, dict(cfg_a, **extra), seed=7, steps_per_epoch=2,
                                   graph=graph)

        res[f"train_{name}"], step = _captured_vs_eager(torch, make, b1, f"train {name}")
        lrs = res[f"train_{name}"]["lrs"]
        if not all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(lrs, (1e-4, 1e-4, 1e-5))):
            raise AssertionError(f"train {name}: learning rates {lrs}, the milestone missed")
        if name == "fp32":
            del model, init, step
            continue
        # (d) A profiled replay against a profiled eager step of the same model.
        eager = make_train_step(model, cfg_a, seed=8, steps_per_epoch=2, graph=False)
        eager(b1[0])
        prof_e, prof_c = profiled(eager, b1[0]), profiled(step, b1[0])
        want = {"k1": 1, "k2": 1, "k3": 2 * n_k3_train, "k4": n_k3_train, "k5": 16,
                "k5_bwd": 16, "stem_pool_bwd": 4}
        res["train_profiled"] = {"eager": prof_e, "replay": prof_c, "expected": want}
        # The replay's trace by kernel name, its counters and the eager
        # step's counters all at phase 8's table. The eager step's trace is
        # logged, not gated: one run's trace lost a K3 event (51 of the
        # counters' 52) that its counters and every replay's trace hold.
        for k in _KERNEL_KEYS:
            if not prof_c[k] == want[k] == prof_c["counters"][k] == prof_e["counters"][k]:
                raise AssertionError(f"train replay launches by name {k}: replay {prof_c}, "
                                     f"eager {prof_e}, expected {want}")
        # (f) Frames/s, captured and eager in turns (host clock, synchronized).
        fps = {"captured": [], "eager": []}
        for kind in ("captured", "eager", "eager", "captured"):
            fn = step if kind == "captured" else eager
            fn(b1[0])
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(b1[0])
                torch.cuda.synchronize()
                fps[kind].append(time.perf_counter() - t0)
        res["train_bf16_frames_per_s"] = {
            k: {"median_ms": 1e3 * sorted(v)[len(v) // 2],
                "median_frames_per_s": 1 / sorted(v)[len(v) // 2], "samples_s": v}
            for k, v in fps.items()}
        del model, init, step, eager
    torch.cuda.empty_cache()

    # (b) The fit's step: the preset's model, B = 3, remat, bf16.
    cfg_b = _preset({"model.compute_dtype": "bfloat16"})
    torch.manual_seed(0)
    model = build_preset_model(cfg_b.model)
    init = copy.deepcopy(model.state_dict())
    b3 = [batch_to(synthetic_batch(FIT_B, HW, HW, OCC, seed=s), "cuda") for s in range(3)]

    def make_fit(graph):
        model.load_state_dict(init)
        return make_train_step(model, cfg_b.model, steps_per_epoch=STEPS_PER_EPOCH, seed=0,
                               optim_cfg=cfg_b, graph=graph)

    res["fit"], step = _captured_vs_eager(torch, make_fit, b3, "fit step")
    prof_c = profiled(step, b3[0])
    want = {"k1": 1, "k2": 1, "k3": per_step["conv3x3"] + per_step["conv3x3_dgrad"],
            "k4": per_step["conv3x3_wgrad"], "k5": per_step["maxpool5x5"],
            "k5_bwd": per_step["maxpool5x5_bwd"], "stem_pool_bwd": per_step["maxpool3x3s2_bwd"]}
    res["fit_profiled"] = {"replay": prof_c, "expected": want}
    if any(prof_c[k] != want[k] or prof_c["counters"][k] != want[k] for k in _KERNEL_KEYS):
        raise AssertionError(f"fit replay launches by name: {prof_c}, expected {want}")
    del model, init, step, b3
    torch.cuda.empty_cache()

    # (c) The eval step at B = 1 (bf16, both branches, with pose).
    model = build_model(torch, torch.bfloat16)
    eager = make_eval_step(model, graph=False)
    captured = make_eval_step(model)
    g = torch.Generator(device="cuda").manual_seed(15)
    frames = [torch.rand(1, 3, 3, HW, HW, device="cuda", generator=g) for _ in range(3)]
    for i, x in enumerate(frames):
        want, got = eager({"color_aug": x}), captured({"color_aug": x})
        if not _same(torch, dict(got), dict(want)):
            raise AssertionError(f"eval call {i + 1}: the captured outputs differ")
    lat = {"captured": [], "eager": []}
    batch = {"color_aug": frames[0]}
    for kind in ("captured", "eager", "eager", "captured"):
        fn = captured if kind == "captured" else eager
        fn(batch)
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            lat[kind].append((time.perf_counter() - t0) * 1e3)
    res["eval_ms"] = {k: {"n": len(v), "median": sorted(v)[len(v) // 2],
                          "p90": sorted(v)[int(0.9 * len(v))], "min": min(v)}
                      for k, v in lat.items()}
    res["eval_captures"] = captured.graphs.captures
    # Streaming: 10 frames, chunks of 4 (4, 4, then 1: two graphs).
    vid = torch.rand(10, 3, HW, HW, device="cuda", generator=g)
    s_eager, s_capt = make_streaming_fn(model, 4, graph=False), make_streaming_fn(model, 4)
    s_times = {"captured": [], "eager": []}
    for i in range(3):
        for kind, fn in (("eager", s_eager), ("captured", s_capt)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = fn(vid)
            torch.cuda.synchronize()
            s_times[kind].append(time.perf_counter() - t0)
            if kind == "eager":
                want = ys
        if not _same(torch, ys, want):
            raise AssertionError(f"streaming run {i + 1}: the captured outputs differ")
    if s_capt.graphs.captures != 2 or ys["global_pose"].shape[0] != 9:
        raise AssertionError(f"streaming: {s_capt.graphs.captures} graphs, "
                             f"{ys['global_pose'].shape[0]} poses")
    res["stream"] = {"captures": s_capt.graphs.captures,
                     "frames_per_s": {k: 9 / min(v) for k, v in s_times.items()},
                     "seconds": s_times}
    del model, eager, captured, s_eager, s_capt, ys, want
    # inv_ex against inv at the CGT's matrices of phase 9's batch.
    bt = batch_to(synthetic_batch(FIT_B, HW, HW, OCC, seed=0), "cuda")
    hsg = _shifted_ground_from_img(bt["odometry_K"][:, :3, :3], bt["Tr_cam2_velo"], 1.73, OCC)
    mats = {"H_sg_img": hsg, "M": torch.linalg.inv(hsg), "H_sg_img[:1]": hsg[:1]}
    res["inv_ex_same_as_inv"] = {k: _same(torch, torch.linalg.inv_ex(m).inverse,
                                          torch.linalg.inv(m)) for k, m in mats.items()}
    if not all(res["inv_ex_same_as_inv"].values()):
        raise AssertionError(f"inv_ex against inv: {res['inv_ex_same_as_inv']}")
    torch.cuda.empty_cache()

    # (f) The captured fits beside phase 9's eager twin.
    res["fit_frames_per_s"] = {
        "phase9_captured_steady": ft["steady_frames_per_s"],
        "phase9_eager_twin_steady": ft["eager_twin"]["steady_frames_per_s"],
        "phase9_captured_profiled_epoch": ft["profiled_epoch"],
        "phase13_captured_steady": kitti["steady_frames_per_s"],
        "phase13_profiled_epoch": kitti["profiled_epoch"],
        "phase13_wait_per_step_s": kitti["steady_data_wait_per_step_s"],
        "phase13_loader_sets_pace": kitti["loader_sets_pace"]}

    # (e) No fallback: a forward that reads a value back, captured, raises.
    class _Syncs(torch.nn.Module):
        def forward(self, batch, train=False, with_pose=True):
            x = batch["color_aug"] * 2
            return {"x": x + 1 if x.sum().item() > 0 else x}

    step = make_eval_step(_Syncs())
    x = torch.rand(1, 1, 3, 8, 8, device="cuda")
    step({"color_aug": x})  # the warm-up runs eagerly
    try:
        step({"color_aug": x})
    except RuntimeError as exc:
        res["no_fallback"] = str(exc)[:300]
    else:
        raise AssertionError("a captured .item() did not raise")
    if "capture of the eval step failed" not in res["no_fallback"]:
        raise AssertionError(f"the failed capture raised {res['no_fallback']}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"graph [{card}]: {json.dumps(res)}")
    return res


# ---- Phase 16: the captured data-parallel step --------------------------------

def _ddpg_schedule() -> tuple[int, int]:
    """Phase 16's steps: DDP's eager warm-ups (`engine/graphs.py::
    DDP_WARMUP`), the capture (which replays once) and three replays; and
    the LR milestone's iteration, between the capture's replay and the
    next."""
    from jperceiver_tpu_torch.engine.graphs import DDP_WARMUP

    return DDP_WARMUP + 1 + 3, DDP_WARMUP + 2


def _ddpg_configs(world: int) -> list:
    """(name, bn_groups, zero1): bn_groups 1, the world size (on one card
    the same step as 1, so not run twice), ZeRO-1."""
    return ([("bn1", 1, False)] + ([("bnW", world, False)] if world > 1 else [])
            + [("zero1", 1, True)])


def _nccl_kernels(dev_events) -> dict:
    """NCCL's kernels in a trace: count and device ms by name."""
    out: dict = {}
    for e in dev_events:
        if "nccl" in e.name.lower():
            row = out.setdefault(e.name, {"count": 0, "ms": 0.0})
            row["count"] += 1
            row["ms"] += e.time_range.elapsed_us() / 1e3
    return out


def _collective_ms(torch, sizes: list[int], reps: int = 5) -> float:
    """Device ms of all-reduces of fp32 buffers of `sizes` elements, back
    to back as a step issues them, captured in a CUDA graph as the step
    holds them and replayed (CUDA events; every rank calls it alike)."""
    import torch.distributed as tdist

    bufs = [torch.zeros(n, device="cuda") for n in sizes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # NCCL's warm-up, as the step's
        for b in bufs:
            tdist.all_reduce(b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: NCCL's watchdog thread queries its events meanwhile.
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for b in bufs:
            tdist.all_reduce(b)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ddpg_collectives(torch, step, eager, batch) -> dict:
    """At more than one rank: the Python-issued all-reduces of one eager
    step (the BatchNorm statistics and the loss denominators; DDP's buckets
    are issued from C++), and the device ms of those all-reduces and of
    the gradients' buckets alone, captured."""
    import torch.distributed as tdist

    eager(batch)
    issued, all_reduce0 = [], tdist.all_reduce

    def counting(t, *a, **k):
        issued.append(t.numel())
        return all_reduce0(t, *a, **k)

    tdist.all_reduce = counting
    try:
        eager(batch)
    finally:
        tdist.all_reduce = all_reduce0
    torch.cuda.synchronize()
    # The gradients' all-reduce as DDP's rebuilt buckets take it: 25 MiB
    # each (its default cap), fp32.
    n_grad = sum(p.numel() for p in step.params)
    cap = 25 * 2 ** 20 // 4
    return {"python_all_reduces": {"count": len(issued), "elements": sum(issued),
                                   "largest": max(issued, default=0)},
            "gradient_elements": n_grad,
            "alone_ms": {"gradient_buckets": _collective_ms(
                torch, [cap] * (n_grad // cap) + [n_grad % cap] * bool(n_grad % cap)),
                         "python_all_reduces": _collective_ms(torch, issued, reps=2)}}


def child_ddp_graph(torch, d: str) -> dict:
    """A rank of phase 16, on its own card over NCCL: the fit's step (the
    kitti_odom_1024 preset, B = 3 a rank, remat, bf16) captured against
    its eager twin from the same weights and batches, for each of
    `_ddpg_configs` (graph=None at one rank, the default; graph=True at
    more, where None stays eager), each step timed; then, for bn_groups 1,
    a profiled replay (the hand kernels and NCCL's kernels by name) and,
    at more than one rank (at one, NCCL moves nothing), the Python-issued
    all-reduces of an eager step and bucket-sized and BatchNorm-sized
    all-reduces alone."""
    from torch.profiler import ProfilerActivity, profile

    from jperceiver_tpu_torch.data import synthetic_batch
    from jperceiver_tpu_torch.engine import make_train_step
    from jperceiver_tpu_torch.engine.trainer import batch_to
    from jperceiver_tpu_torch.models import build_model
    from jperceiver_tpu_torch.ops import cuda as kernels
    from jperceiver_tpu_torch.parallel import init_distributed, rank, world_size

    with open(os.path.join(d, "args.json")) as f:
        args = json.load(f)
    init_distributed("nccl", timeout_s=CHILD_TIMEOUT_S)
    r, w = rank(), world_size()
    res = {"rank": r, "world": w, "card": torch.cuda.get_device_name(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "env": {k: v for k, v in os.environ.items() if "NCCL" in k}, "configs": {}}
    # Each rank its own batches (rows of no common global batch: the
    # comparison is captured against eager, rank by rank).
    batches = [batch_to(synthetic_batch(DDP_B, HW, HW, OCC, seed=100 * r + s), "cuda")
               for s in range(2)]
    n_calls, milestone = _ddpg_schedule()
    calls = [batches[i % 2] for i in range(n_calls)]
    torch.manual_seed(0)
    init = build_model(_preset({"model.compute_dtype": "bfloat16"}).model).state_dict()

    def make(groups, zero1, graph):
        cfg = _preset({"model.compute_dtype": "bfloat16", "model.bn_groups": groups,
                       "lr_config.step": [1]})
        model = build_model(cfg.model)
        model.load_state_dict(init)
        return make_train_step(model, cfg.model, steps_per_epoch=milestone, seed=0,
                               optim_cfg=cfg, zero1=zero1,
                               graph=graph if graph is False or w == 1 else True)

    for name, groups, zero1 in _ddpg_configs(w):
        t0 = time.perf_counter()
        out, step = _captured_vs_eager(
            torch, lambda graph: make(groups, zero1, graph), calls,
            f"ddp_graph {name} (rank {r} of {w})")
        lrs = out.pop("lrs")
        want = [1e-4] * milestone + [1e-5] * (n_calls - milestone)
        if not all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(lrs, want)):
            raise AssertionError(f"ddp_graph {name}: learning rates {lrs}, expected {want}")
        out.update(seconds=time.perf_counter() - t0, lr_first_last=[lrs[0], lrs[-1]])
        res["configs"][name] = out
        if name != "bn1":
            del step
            torch.cuda.empty_cache()
            continue
        # A profiled replay: the hand kernels and NCCL's kernels by name;
        # the memory the captured step holds (the compare's eager twin and
        # snapshots are gone), its graph's pool among the reserved bytes.
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batches[0])
            torch.cuda.synchronize()
        replay = _prof_counts(torch, prof)
        replay["launch_counts"] = kernels.launch_counts()
        replay["counters"] = _counters_as_profiled(replay["launch_counts"])
        replay["nccl"] = _nccl_kernels(_device_events(prof))
        replay["nccl_ms"] = sum(v["ms"] for v in replay["nccl"].values())
        res["replay"] = replay
        res["captured_memory_gb"] = {"peak_allocated": torch.cuda.max_memory_allocated() / 1e9,
                                     "reserved": torch.cuda.memory_reserved() / 1e9}
        want_k = args["expected_replay"]
        if any(replay[k] != want_k[k] or replay["counters"][k] != want_k[k]
               for k in _KERNEL_KEYS):
            raise AssertionError(f"ddp_graph rank {r}: replay launches {replay}, expected "
                                 f"{want_k}")
        # A rank's step from the compare: eager past its first step, captured
        # over the replays after the capture.
        secs = out["step_s"]
        timed = {"eager": secs["eager"][1:],
                 "captured": secs["captured"][step.graphs.warmup + 1:]}
        res["step_s"] = {k: {"median": sorted(v)[len(v) // 2], "samples": v}
                         for k, v in timed.items()}
        res["frames_per_s"] = {k: DDP_B / v["median"] for k, v in res["step_s"].items()}
        if w > 1:
            res.update(_ddpg_collectives(torch, step, make(groups, zero1, False), batches[0]))
        del step
        torch.cuda.empty_cache()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def phase_ddp_graph(torch, card: str, per_step: dict, world: int,
                    env_extra: dict | None = None) -> dict:
    """Phase 16: the captured data-parallel step (`engine/graphs.py`: DDP,
    the global or per-rank BatchNorm, the loss denominators and ZeRO-1 in
    one CUDA graph a rank), `world` NCCL ranks in child processes, one a
    card, at the fit's step (kitti_odom_1024: 1024^2, occ 256, B = 3 a
    rank, remat, bf16, road branch):
      (a) for bn_groups 1, the world size and ZeRO-1 (`_ddpg_configs`),
          the captured step against its eager twin (graph=False) from the
          same weights and batches over `DDP_WARMUP` warm-ups, the capture
          and three replays, the LR 10x lower from iteration 13: every
          metric, gradient and weight a step, then the model (BatchNorm
          statistics included), Adam's moments and the generator, bit for
          bit, on every rank;
      (b) each hand kernel's launches in a profiled replay, by name and by
          the counters, the one-process fit step's (`per_step`); NCCL's
          kernels in it by name with their device ms;
      (c) times (not gated): a rank's step captured and eager, from (a)'s
          bn_groups 1 run, with frames/s a rank and in all, the replay's
          busy ms and idle share, the capture's seconds, peak memory; at
          more than one rank the Python-issued all-reduces of a step, and
          DDP's buckets and those all-reduces timed alone."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_ddp_graph_")
    t_phase = time.perf_counter()
    want = {"k1": per_step["reproj_fwd"], "k2": per_step["reproj_bwd"],
            "k3": per_step["conv3x3"] + per_step["conv3x3_dgrad"],
            "k4": per_step["conv3x3_wgrad"], "k5": per_step["maxpool5x5"],
            "k5_bwd": per_step["maxpool5x5_bwd"], "stem_pool_bwd": per_step["maxpool3x3s2_bwd"]}
    try:
        with open(os.path.join(d, "args.json"), "w") as f:
            json.dump({"expected_replay": want}, f)
        ranks = _run_children("ddp_graph", d, world, CHILD_TIMEOUT_S, env_extra,
                              one_card_each=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r0 = ranks[0]
    res = {"card": card, "world": world, "env_extra": env_extra or {}, "ranks": ranks,
           "frames_per_s_per_rank": r0["frames_per_s"],
           "frames_per_s_total": {k: world * v for k, v in r0["frames_per_s"].items()},
           "seconds": time.perf_counter() - t_phase}
    log(f"ddp_graph [{card}] x {world}: {json.dumps(res)}")
    return res


def fit_per_step(train_sites, remat_trunks) -> dict:
    """Each hand kernel's launches a step of phase 9's fit: under remat
    every K3 site and CRP pool of a checkpointed trunk runs its forward
    again in the backward."""
    trunks = set(remat_trunks)
    n_k3 = sum(s["k3"] for s in train_sites)
    n_k3_re = sum(s["k3"] for s in train_sites if s["module"] in trunks)
    n_k5_re = 16 if "DepthDecoder" in trunks else 0
    return {"conv3x3": n_k3 + n_k3_re, "conv3x3_dgrad": n_k3, "conv3x3_wgrad": n_k3,
            "maxpool5x5": 16 + n_k5_re, "maxpool5x5_bwd": 16, "maxpool5x5_bwd_cot_copy": 0,
            "maxpool3x3s2_bwd": 4, "maxpool3x3s2_bwd_cot_copy": 0, "reproj_fwd": 1,
            "reproj_bwd": 1}


def main_ddp_graph(worlds: list[int]) -> int:
    """`chip_smoke.py --ddp-graph W [W ...]`: phase 16 alone at each world
    size W (W cards, one NCCL rank each), its readings in
    chiprun_out/ddp_graph.json and, a line a world size, on stdout."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < max(worlds):
        log(f"chip_smoke --ddp-graph: needs {max(worlds)} CUDA devices")
        return 2
    sys.path.insert(0, ROOT)
    from jperceiver_tpu_torch.models import build_model
    from jperceiver_tpu_torch.models.jperceiver import conv3x3_sites
    from jperceiver_tpu_torch.ops.cuda import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print("\n".join(card), flush=True)
    _build.library()
    with torch.device("meta"):
        trunks = build_model(_preset({}).model).remat_trunks
    per_step = fit_per_step(conv3x3_sites(HW, HW, OCC, branches="road"), trunks)
    out = {}
    for w in worlds:
        out[w] = phase_ddp_graph(torch, card[0], per_step, w)
        print(json.dumps({"world": w, "frames_per_s_per_rank": out[w]["frames_per_s_per_rank"],
                          "frames_per_s_total": out[w]["frames_per_s_total"],
                          "seconds": out[w]["seconds"]}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ddp_graph.json"), "w") as f:
        json.dump({"cards": card, "worlds": out}, f, indent=1)
    return 0


def tf32_entries(kt: dict) -> list[dict]:
    """The kernel table's rows of phase 17: K3's TF32 path as the forward
    and as the data-grad, and K4's, device ms a 1024^2 fp32 B=1 step (each site's
    time at B = 1 by its launches a step), beside its bound at PEAK_TF32,
    cuDNN's TF32 ("library"), the exact fp32 kernel and the plain version
    (cuDNN in exact fp32); launches a replay of the captured step."""
    per, launches = kt["per_step"], kt["main_path"]["tf32_on"]["tf32_launches"]
    rows = []
    for kid, name, key, counter, replaces in (
            ("K3-TF32", "conv3x3_fwd_tf32", "fwd", "conv3x3",
             "jperceiver_tpu/ops/pallas/conv3x3.py:57"),
            ("K3-dgrad-TF32", "conv3x3_dgrad_tf32", "dgrad", "conv3x3_dgrad",
             "jperceiver_tpu/ops/pallas/conv3x3.py:242"),
            ("K4-TF32", "conv3x3_wgrad_tf32", "wgrad", "conv3x3_wgrad",
             "jperceiver_tpu/ops/pallas/conv3x3.py:145")):
        ms, lib = per[key + "_ms"], per[key + "_library_ms"]
        rows.append({"id": kid, "name": name, "route": "cuda",
                     "source": K4_SRC if key == "wgrad" else K3_SRC,
                     "replaces": replaces, "launches": launches[counter],
                     "max_err_tf32_gaps": max(r[key + "_err_gaps"] for r in kt["rows"]),
                     "ms": ms, "plain_ms": per[key + "_plain_ms"],
                     "exact_ms": per[key + "_exact_ms"], "bound_ms": per[key + "_bound_ms"],
                     "bound_by": "operations", "library_ms": lib,
                     "bound_share": per[key + "_bound_ms"] / ms, "library_ratio": ms / lib})
    return rows


def main_k3_tf32() -> int:
    """`chip_smoke.py --k3-tf32`: phase 17 alone, its rows of the kernel
    table on stdout and its readings in chiprun_out/k3_tf32_smoke.json."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke --k3-tf32: no CUDA device")
        return 2
    sys.path.insert(0, ROOT)
    from jperceiver_tpu_torch.models.jperceiver import conv3x3_sites
    from jperceiver_tpu_torch.ops.cuda import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.library()
    kt = phase_k3_tf32(torch, conv3x3_sites(HW, HW, OCC, branches="road"))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k3_tf32_smoke.json"), "w") as f:
        json.dump({"card": card, "k3_tf32": kt}, f, indent=1)
    print(json.dumps({"kernels": tf32_entries(kt)}), flush=True)
    return 0


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
    kt = phase_k3_tf32(torch, train_sites)
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

    n_fit = FIT_EPOCHS * ft["steps_per_epoch"]
    per_step = fit_per_step(train_sites, ft["remat_trunks"])
    ft["expected_launches_per_step"] = per_step
    if ft["launches"] != {k: v * n_fit for k, v in per_step.items()}:
        raise AssertionError(f"fit main-path launches {ft['launches']}, expected "
                             f"{n_fit} x {per_step}")
    fp = ft["profiler_per_step"]
    if (fp["k1"], fp["k2"], fp["k3"], fp["k4"], fp["k5"], fp["k5_bwd"], fp["stem_pool_bwd"]) != (
            1, 1, per_step["conv3x3"] + n_k3_train, n_k3_train, per_step["maxpool5x5"], 16, 4):
        raise AssertionError(f"fit profiler kernel counts a step {fp}, expected {per_step}")
    # Phase 14: the fp32 and bf16 steps repeat bit for bit (in a child), which
    # phases 10 and 11(a) then hold whole runs to.
    rep = phase_repeat(torch, card)
    # Phase 10: the tools around the fit, each stage's launches checked there
    # against per_step and the eval forward's sites.
    wf = phase_workflow(torch, train_sites, per_step)
    # Phases 11-12: data parallel (each rank's step launches per_step) and the
    # profiling tools.
    dp = phase_ddp(torch, card, per_step, n_k3_train)
    tools = phase_tools(torch, card)
    # Phase 13: the preset trained from a KITTI file tree through the packaged
    # lists, its launches per_step a step; odometry against the packaged poses.
    kitti = phase_kitti(torch, card, per_step, n_k3_train)
    log(f"fit beside kitti_files [{card}]: frames/s past start-up "
        f"{ft['steady_frames_per_s']:.3f} / {kitti['steady_frames_per_s']:.3f}, idle share "
        f"{ft['profiled_epoch']['idle_share']:.3f} / "
        f"{kitti['profiled_epoch']['idle_share']:.3f}, decode / load ms a sample "
        f"{kitti['decode_ms_per_sample']:.1f} / {kitti['load_ms_per_sample']:.1f}")
    # Phase 15: the entry points as CUDA graphs against their eager twins.
    graph = phase_graph(torch, card, per_step, n_k3_train, ft, kitti)
    # Phase 16: the captured data-parallel step, one NCCL rank a card.
    ddpg = phase_ddp_graph(torch, card, per_step, torch.cuda.device_count())

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
    for row in table["kernels"]:  # launches of phases 9-11 and 13
        counter = {"conv3x3_fwd": "conv3x3", "maxpool5x5_fwd": "maxpool5x5"}.get(
            row["name"], row["name"])
        row["fit_launches"] = fl[counter]
        row["workflow_launches"] = {stage: n[counter] for stage, n in wf["launches"].items()}
        # Per rank, per step: phase 11(a)'s step (bn_groups 1) on each rank.
        row["ddp_launches"] = {f"rank{r['rank']}": r["steps"]["1"]["launches"][counter]
                               for r in dp["a"]["ranks"]}
        row["kitti_launches"] = kitti["launches"][counter]
        # Per rank, in a profiled replay of phase 16's captured step.
        row["ddp_graph_launches"] = {f"rank{r['rank']}": r["replay"]["launch_counts"][counter]
                                     for r in ddpg["ranks"]}
    # Phase 17's rows: K3's TF32 path, its launches in the captured fp32 step.
    table["kernels"] += tf32_entries(kt)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "ptxas": ptxas, "k3_sites": n_k3,
                   "k3": k3, "k5": k5, "stem_pool": sp, "eval": ev, "stream": st, "reproj": rp,
                   "conv_bwd": cb, "train": tr, "k3_tf32": kt, "fit": ft, "workflow": wf,
                   "ddp": dp, "tools": tools, "kitti": kitti, "repeat": rep, "graph": graph,
                   "ddp_graph": ddpg,
                   "seconds": time.perf_counter() - t_start, "table": table},
                  f, indent=1)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":  # a rank of phases 11, 14, 16
        sys.exit(child_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ddp-graph":  # phase 16 alone, on W cards
        sys.exit(main_ddp_graph([int(w) for w in sys.argv[2:]]))
    if sys.argv[1:] == ["--k3-tf32"]:  # phase 17 alone
        sys.exit(main_k3_tf32())
    sys.exit(main())
