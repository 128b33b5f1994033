#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`jperceiver_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit; build the CUDA kernels from csrc/;
  2. K3 (3x3 conv) against its plain version at every K3 site shape of the
     1024^2 eval forward, bf16 and fp32, pad 0 and 1, timed beside F.conv2d;
  3. K5 (5x5 max-pool) against its plain version, bit for bit, at the four
     CRP shapes with ties, timed beside F.max_pool2d;
  4. the eval step at 1024^2, occ 256, both BEV branches, with pose, random
     weights from a seed: fp32 with the kernels on against off (cuDNN and
     the plain pool, TF32 off), bf16 finite and timed both ways, kernel
     launches counted on the main path and in a profiler trace;
  5. streaming inference over 9 frames at 1024^2 in bf16, chunk 4, its
     kernel launches counted and its rotations checked orthonormal;
  6. K1/K2 (reprojection loss forward/backward) against their plain
     versions at the training step's shapes, bf16 and fp32, and B=2 bf16,
     with exact frame ties, timed beside the plain versions and the ATen
     path (reprojection_loss + amin, forward and autograd backward); in
     fp32 also on arbitrary pixels and on grid_sample outputs, with K2 and
     its plain version both held to the float64 autograd gradient;
  7. K3 as the data-grad (pad 2 and 1) and K4 (weight-grad) against their
     plain versions at every K3 site shape of the step, bf16 and fp32,
     timed beside cuDNN's conv2d_input / conv2d_weight;
  8. the flagship training step at 1024^2 (bench.py's configuration: road
     branch, B=1, Adam, clip 35), random weights from a seed: fp32 with the
     kernels on against off, both against the step in float64 (losses and
     gradients; the library route's own spread under a rounding-level
     change of the input sets each gradient's bound), bf16 for 20 steps on
     one batch (finite, falling loss, BatchNorm statistics moving),
     frames/s with the kernels on and off in turns, the kernel launches of
     one step from the counters and a profiler trace, its device busy time,
     idle share and peak memory.

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
K3_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/conv3x3.cu"
K5_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/maxpool5x5.cu"
K4_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/conv3x3_wgrad.cu"
K12_SRC = "jperceiver_tpu_torch/ops/cuda/csrc/reproj.cu"
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
# Operations a pixel, channel and frame of the fused reprojection loss (3x3
# separable sums of x, x^2, xy; the SSIM and Charbonnier terms), forward
# and backward (the backward recomputes the forward and gathers 3 fields).
REPROJ_OPS_FWD, REPROJ_OPS_BWD = 40.0, 120.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
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


def bound_ms(n_bytes: float, n_ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_k3(torch, sites) -> dict:
    from jperceiver_tpu_torch.ops.cuda import conv3x3_fwd, conv3x3_plain

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"])
                     for s in sites if s["k3"])
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
                        sites_per_forward=count, bound_ms=bnd, bound_by=by,
                        ms=time_ms(torch, lambda: conv3x3_fwd(x, wt, b, pad)),
                        plain_ms=time_ms(torch, lambda: conv3x3_plain(x, wt, b, pad)),
                        library_ms=time_ms(torch, lambda: F.conv2d(x, wt, b, padding=pad)))
                    if dtype == torch.bfloat16:
                        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                            tot[k] += count * row[k]
                        ops_t += count * n_ops / peak
                        bytes_t += count * n_bytes / HBM_BYTES_S
                rows.append(row)
                log(f"K3 {row}")
    return {"rows": rows, "max_abs_err": max_err, "per_forward": dict(tot),
            "bound_by": "bytes" if bytes_t >= ops_t else "operations"}


def phase_k5(torch) -> dict:
    from jperceiver_tpu_torch.ops.cuda import maxpool5x5_fwd, maxpool5x5_plain

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    tot = Counter()
    cases = [(256, s, torch.bfloat16, 4) for s in (32, 64, 128, 256)]
    cases += [(256, 64, torch.float32, 0), (13, 20, torch.bfloat16, 0)]
    for c, s, dtype, per_forward in cases:
        # Quarter steps through a ReLU: zero plateaus and repeated values.
        x = torch.relu(torch.round(4 * torch.randn(1, c, s, s, device="cuda",
                                                   generator=g)) / 4)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        y = maxpool5x5_fwd(x)
        ref = maxpool5x5_plain(x)
        torch.cuda.synchronize()
        row = {"c": c, "h": s, "w": s, "dtype": str(dtype),
               "bit_exact": bool(torch.equal(y, ref)),
               "max_abs_err": (y.float() - ref.float()).abs().max().item()}
        if not row["bit_exact"]:
            raise AssertionError(f"K5 differs from its plain version: {row}")
        if per_forward:
            n = x.numel()
            bnd, by = bound_ms(2 * n * x.element_size(), 24.0 * n, PEAK_FP32)
            row.update(
                pools_per_forward=per_forward, bound_ms=bnd, bound_by=by,
                ms=time_ms(torch, lambda: maxpool5x5_fwd(x)),
                plain_ms=time_ms(torch, lambda: maxpool5x5_plain(x)),
                library_ms=time_ms(torch, lambda: F.max_pool2d(x, 5, 1, 2)))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += per_forward * row[k]
        rows.append(row)
        log(f"K5 {row}")
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "per_forward": dict(tot), "bound_by": "bytes"}


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
    image: exact frame ties there."""
    p = _levels(torch, g, shape) if levels else torch.rand(shape, device="cuda", generator=g)
    if shape[2] > 1:
        p[:, :, 1, ..., : shape[-1] // 2] = p[:, :, 0, ..., : shape[-1] // 2]
    return p.to(dtype)


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
    rl = rl.detach()
    gap = (rl[:, :, 0] - rl[:, :, 1]).abs()
    amb = ((gap > 0) & (gap < 1e-5)).float().reshape(s_ * b_, 1, h, w)
    keep = (F.max_pool2d(amb, 5, 1, 2) == 0).reshape(s_, b_, 1, 1, h, w)
    ek = (d.double() - g64) * keep
    ep = (dref.double() - g64) * keep
    out = {"k2_err_f64": ek.abs().max().item(), "plain_err_f64": ep.abs().max().item(),
           "k2_rms_f64": ek.pow(2).mean().sqrt().item(),
           "plain_rms_f64": ep.pow(2).mean().sqrt().item(),
           "grad_f64_max": g64.abs().max().item(), "f64_pixels_masked": int((~keep).sum().item())}
    del p, rl, best, g64, ek, ep
    return out


def phase_reproj(torch) -> dict:
    from jperceiver_tpu_torch.ops.cuda.reproj import (_bwd, _fwd, _reproj_bwd_plain,
                                                      reproj_min_plain)
    from jperceiver_tpu_torch.ops.photometric import reprojection_loss

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    # (shape, dtype, operands, role in one training step): the warped stack
    # and the automask identity pairs at B=1 in bf16 (the flagship's
    # operands), B=2 in bf16, and in fp32 the warped stack on 8-bit levels,
    # on arbitrary fp32 pixels and on grid_sample outputs. On 8-bit levels
    # the window sums are exact in both versions; on the other fp32
    # operands both versions round them, and each is held to the float64
    # gradient as well as to the other.
    cases = [((4, 1, 2, 3, HW, HW), bf16, "levels", "warped"),
             ((2, 1, 1, 3, HW, HW), bf16, "levels", "identity"),
             ((4, 2, 2, 3, HW, HW), bf16, "levels", None),
             ((4, 1, 2, 3, HW, HW), f32, "levels", None),
             ((4, 1, 2, 3, HW, HW), f32, "arbitrary", None),
             ((4, 1, 2, 3, HW, HW), f32, "grid_sample", None)]
    rows, tot = [], Counter()
    err_f = err_b = 0.0
    for shape, dtype, operands, role in cases:
        s_, b_, f_ = shape[:3]
        if operands == "grid_sample":
            preds = _warped_preds(torch, g, shape)
            targ = torch.rand((b_, 3, HW, HW), device="cuda", generator=g)
        else:
            preds = _tie_preds(torch, g, shape, dtype, levels=operands == "levels")
            targ = (_levels(torch, g, (b_, 3, HW, HW)) if operands == "levels"
                    else torch.rand((b_, 3, HW, HW), device="cuda", generator=g)).to(dtype)
        cot = torch.randn((s_, b_, HW, HW), device="cuda", generator=g)
        out, ref = _fwd(preds, targ), reproj_min_plain(preds, targ)
        torch.cuda.synchronize()
        ef = (out - ref).abs().max().item()
        # Both sum the same fp32 statistics in another order; values are O(1).
        row = {"shape": list(shape), "dtype": str(dtype), "operands": operands, "role": role,
               "fwd_max_abs_err": ef, "fwd_tol": 2e-5}
        if not ef <= 2e-5:
            raise AssertionError(f"K1 disagrees with its plain version: {row}")
        err_f = max(err_f, ef)
        if f_ > 1:
            d, dref = _bwd(preds, targ, cot), _reproj_bwd_plain(preds, targ, cot)
            # A frame-min decided by less than the two versions' rounding may
            # route a pixel's cotangent to the other frame; the gradient of a
            # pixel reads the routing within 2 pixels of it. Exact ties (the
            # copied half) are ties in both and stay in the comparison.
            rl = reprojection_loss(preds.float(), targ.float()[:, None])[:, :, :, 0]
            gap = (rl[:, :, 0] - rl[:, :, 1]).abs()
            amb = ((gap > 0) & (gap < 1e-5)).float().reshape(s_ * b_, 1, HW, HW)
            keep = (F.max_pool2d(amb, 5, 1, 2) == 0).reshape(s_, b_, 1, 1, HW, HW)
            diff = ((d.float() - dref.float()).abs() * keep).max().item()
            scale = dref.float().abs().max().item()
            tol = (1e-4 if dtype == f32 else 1e-2) * scale
            ties = (rl[:, :, 0] == rl[:, :, 1]).sum().item()
            row.update(bwd_max_abs_err=diff, bwd_tol=tol, exact_tie_pixels=ties,
                       near_tie_pixels_masked=int(amb.sum().item()),
                       pixels_masked=int((~keep).sum().item()))
            del rl, gap, amb, keep
            if dtype == f32:
                # K2 no farther from float64 than its plain version: its
                # largest distance within 2x the plain version's, its RMS
                # distance within 1.25x.
                row.update(_k2_f64_witness(torch, preds, targ, cot, d, dref))
                if not (row["k2_err_f64"] <= 2 * row["plain_err_f64"]
                        and row["k2_rms_f64"] <= 1.25 * row["plain_rms_f64"]):
                    raise AssertionError(f"K2 farther from float64 than its plain version: {row}")
            if operands == "levels" and not diff <= tol:
                raise AssertionError(f"K2 disagrees with its plain version: {row}")
            err_b = max(err_b, diff) if operands == "levels" else err_b
            del d, dref
        if role is not None:
            n_in = preds.numel() * preds.element_size() + targ.numel() * targ.element_size()
            n_pix = preds.numel()  # pixels x channels x frames x scales
            bnd, by = bound_ms(n_in + 4 * s_ * b_ * HW * HW, REPROJ_OPS_FWD * n_pix, PEAK_FP32)

            def lib_fwd():
                return reprojection_loss(preds, targ[:, None]).amin(2)[:, :, 0]

            row.update(bound_ms=bnd, bound_by=by,
                       ms=time_ms(torch, lambda: _fwd(preds, targ), reps=10),
                       plain_ms=time_ms(torch, lambda: reproj_min_plain(preds, targ), reps=5),
                       library_ms=time_ms(torch, lib_fwd, reps=5))
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot["k1_" + k] += row[k]
            if role == "warped":
                pg = preds.detach().requires_grad_()

                def lib_fwd_bwd():
                    reprojection_loss(pg, targ[:, None]).amin(2)[:, :, 0].backward(cot)

                bnd, by = bound_ms(2 * n_in + 4 * s_ * b_ * HW * HW,
                                   REPROJ_OPS_BWD * n_pix, PEAK_FP32)
                row.update(bwd_bound_ms=bnd, bwd_bound_by=by,
                           bwd_ms=time_ms(torch, lambda: _bwd(preds, targ, cot), reps=10),
                           bwd_plain_ms=time_ms(
                               torch, lambda: _reproj_bwd_plain(preds, targ, cot), reps=5),
                           bwd_library_ms=time_ms(torch, lib_fwd_bwd, reps=5) - row["library_ms"])
                for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    tot["k2_" + k] += row["bwd_" + k]
                tot["bound_by_fwd"], tot["bound_by_bwd"] = row["bound_by"], by
        rows.append(row)
        log(f"K1/K2 {row}")
        del preds, targ, cot, out, ref
        torch.cuda.empty_cache()
    return {"rows": rows, "k1_max_abs_err": err_f, "k2_max_abs_err": err_b,
            "per_step": dict(tot)}


def phase_conv_bwd(torch, sites) -> dict:
    """K3 as the data-grad and K4 at every K3 site shape of the step."""
    from jperceiver_tpu_torch.ops.cuda import conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain
    from jperceiver_tpu_torch.ops.cuda.conv3x3 import _conv

    grad = torch.nn.grad
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = Counter((s["c_in"], s["c_out"], s["h"], s["w"], s["pad"]) for s in sites if s["k3"])
    rows, tot = [], Counter()
    err_d = err_w = 0.0
    ops_t = bytes_t = 0.0
    for (c, o, h, w, pad), count in sorted(shapes.items()):
        for dtype in (torch.bfloat16, torch.float32):
            hin, win = h + 2 - 2 * pad, w + 2 - 2 * pad
            x = torch.randn(1, c, hin, win, device="cuda", generator=g).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / math.sqrt(9 * c)).to(dtype)
            gy = torch.randn(1, o, h, w, device="cuda", generator=g).to(dtype)
            gy = gy.contiguous(memory_format=torch.channels_last)
            wflip = wt.flip(2, 3).transpose(0, 1)
            dx = _conv(gy, wflip, None, 2 - pad, "conv3x3_dgrad")
            dx_ref = conv3x3_plain(gy, wflip, None, 2 - pad)
            dw = conv3x3_wgrad(x, gy, pad)
            dw_ref = conv3x3_wgrad_plain(x, gy, pad)
            torch.cuda.synchronize()
            ed = (dx.float() - dx_ref.float()).abs().max().item()
            sd = max(1.0, dx_ref.float().abs().max().item())
            ew = (dw - dw_ref).abs().max().item()
            sw = dw_ref.abs().max().item()
            # dgrad: as K3's forward (fp32 order; one bf16 rounding). K4: fp32
            # sums of 9C x O over M pixels in another order, both dtypes.
            row = {"c_in": c, "c_out": o, "h": h, "w": w, "pad": pad, "dgrad_pad": 2 - pad,
                   "dtype": str(dtype), "dgrad_max_abs_err": ed,
                   "dgrad_tol": (1e-4 if dtype == torch.float32 else 1e-2) * sd,
                   "wgrad_max_abs_err": ew, "wgrad_tol": 1e-4 * sw,
                   "dx_shape": list(dx.shape)}
            if not (ed <= row["dgrad_tol"] and tuple(dx.shape) == tuple(x.shape)):
                raise AssertionError(f"K3 data-grad disagrees with its plain version: {row}")
            if not (ew <= row["wgrad_tol"] and tuple(dw.shape) == (o, c, 3, 3)):
                raise AssertionError(f"K4 disagrees with its plain version: {row}")
            err_d, err_w = max(err_d, ed), max(err_w, ew)
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
                row.update(
                    sites_per_step=count, dgrad_bound_ms=bd, wgrad_bound_ms=bw,
                    dgrad_ms=time_ms(torch, lambda: _conv(gy, wflip, None, 2 - pad, "conv3x3_dgrad"), reps=10),
                    dgrad_plain_ms=time_ms(torch, lambda: conv3x3_plain(gy, wflip, None, 2 - pad), reps=5),
                    dgrad_library_ms=time_ms(torch, lambda: grad.conv2d_input(x.shape, wt, gy, padding=pad), reps=10),
                    wgrad_ms=time_ms(torch, lambda: conv3x3_wgrad(x, gy, pad), reps=10),
                    wgrad_plain_ms=time_ms(torch, lambda: conv3x3_wgrad_plain(x, gy, pad), reps=5),
                    wgrad_library_ms=time_ms(torch, lambda: grad.conv2d_weight(x, wt.shape, gy, padding=pad), reps=10))
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
        set_kernels(model, on, on, on)
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
        set_kernels(model, on, on, on)
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
    set_kernels(model, True, True, True)
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

    res["profiler"] = {
        "k1": count("reproj_fwd"), "k2": count("reproj_bwd"), "k3": count("conv3x3_bf16"),
        "k4": count("wgrad_bf16"), "k5": count("maxpool5x5_nhwc"),
        "device_events": sum(names.values()), "device_busy_ms": busy_ms,
        "device_span_ms": span_ms, "idle_share": 1 - busy_ms / span_ms if span_ms else None,
        "top_kernels_ms": dict(busy.most_common(12)),
    }
    log(f"train launches {res['launches']}; peak {res['peak_memory_gb']:.2f} GB; "
        f"profiler {res['profiler']}")
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

    sites = conv3x3_sites(HW, HW, OCC)
    n_k3 = sum(s["k3"] for s in sites)
    k3 = phase_k3(torch, sites)
    k5 = phase_k5(torch)
    ev = phase_eval(torch)
    st = phase_stream(torch, n_k3)
    rp = phase_reproj(torch)
    # The training step runs the road branch only; its K3 sites are the
    # eval forward's (no layout-decoder site is eligible).
    train_sites = conv3x3_sites(HW, HW, OCC, branches="road")
    n_k3_train = sum(s["k3"] for s in train_sites)
    cb = phase_conv_bwd(torch, train_sites)
    tr = phase_train(torch)

    launches = ev["launches"]
    if launches != {k: 0 for k in launches} | {"conv3x3": n_k3, "maxpool5x5": 16}:
        raise AssertionError(f"eval main-path launches {launches}, expected "
                             f"conv3x3 {n_k3} and maxpool5x5 16 only")
    prof = ev["profiler"]
    if (prof["k3"], prof["k5"]) != (n_k3, 16):
        raise AssertionError(f"eval profiler kernel counts {prof}, expected "
                             f"K3 {n_k3} and K5 16")
    want = {"conv3x3": n_k3_train, "conv3x3_dgrad": n_k3_train,
            "conv3x3_wgrad": n_k3_train, "maxpool5x5": 16, "reproj_fwd": 2, "reproj_bwd": 1}
    if tr["launches"] != want:
        raise AssertionError(f"train main-path launches {tr['launches']}, expected {want}")
    tp = tr["profiler"]
    if (tp["k1"], tp["k2"], tp["k3"], tp["k4"], tp["k5"]) != (2, 1, 2 * n_k3_train,
                                                                n_k3_train, 16):
        raise AssertionError(f"train profiler kernel counts {tp}")

    def entry(kid, name, src, replaces, count, err, per, bound_by):
        return {"id": kid, "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": count, "max_abs_err": err,
                "ms": per["ms"], "plain_ms": per["plain_ms"], "bound_ms": per["bound_ms"],
                "bound_by": bound_by, "library_ms": per["library_ms"]}

    rps, cbs, tl = rp["per_step"], cb["per_step"], tr["launches"]

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
    ]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "k3_sites": n_k3,
                   "k3": k3, "k5": k5, "eval": ev, "stream": st, "reproj": rp,
                   "conv_bwd": cb, "train": tr,
                   "seconds": time.perf_counter() - t_start, "table": table},
                  f, indent=1)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
