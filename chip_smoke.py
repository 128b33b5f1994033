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
     kernel launches counted and its rotations checked orthonormal.

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


def build_model(torch, dtype):
    from jperceiver_tpu_torch.models import JPerceiver

    torch.manual_seed(0)
    model = JPerceiver(occ_map_size=OCC, dtype=dtype, branches="both")
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
    if launches != {"conv3x3": 2 * n_k3, "maxpool5x5": 2 * 16}:
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

    launches = ev["launches"]
    if launches != {"conv3x3": n_k3, "maxpool5x5": 16}:
        raise AssertionError(f"main-path launches {launches}, expected "
                             f"conv3x3 {n_k3} and maxpool5x5 16")
    prof = ev["profiler"]
    if (prof["k3"], prof["k5"]) != (n_k3, 16):
        raise AssertionError(f"profiler kernel counts {prof}, expected "
                             f"K3 {n_k3} and K5 16")

    def entry(kid, name, src, replaces, count, ph):
        pf = ph["per_forward"]
        return {"id": kid, "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": count,
                "max_abs_err": ph["max_abs_err"], "ms": pf["ms"],
                "plain_ms": pf["plain_ms"], "bound_ms": pf["bound_ms"],
                "bound_by": ph["bound_by"], "library_ms": pf["library_ms"]}

    table = {"kernels": [
        entry("K3", "conv3x3_fwd", K3_SRC,
              "jperceiver_tpu/ops/pallas/conv3x3.py:57", launches["conv3x3"], k3),
        entry("K5", "maxpool5x5_fwd", K5_SRC,
              "jperceiver_tpu/ops/pallas/maxpool.py:183", launches["maxpool5x5"], k5),
    ]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "k3_sites": n_k3,
                   "k3": k3, "k5": k5, "eval": ev, "stream": st,
                   "seconds": time.perf_counter() - t_start, "table": table},
                  f, indent=1)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
