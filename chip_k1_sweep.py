#!/usr/bin/env python3
"""What holds the reprojection forward K1 above its bound, on one GPU.

    python3 chip_k1_sweep.py

At the flagship step's operands (the warped stack (4, 1, 2, 3, 1024, 1024)
and the two identity frames against one target, bf16 and fp32, with the
routing code, as one K1 launch), times through K1's C entry point:

  * the kernel at each tile height K1 takes (32, 16, 8 rows; `k1_plan`
    picks 32 at this size);
  * variants of `csrc/reproj.cu` built beside it from its own text: with
    the launch bound at two and four blocks of 256 threads a SM (the kernel
    has three), and two that do half of the work each -- "staging only"
    (every frame staged, no arithmetic) and "arithmetic only" (the first
    frame staged, the arithmetic run on every frame) -- whose results are
    wrong and are not checked.

The kernel and the launch-bound variants are checked against the plain
version. Times are device times (`chip_smoke.py::time_ms`), three
repetitions each. Registers and spills come from `nvcc -Xptxas -v`. Prints
one JSON line a case; all of it goes to chiprun_out/k1_sweep.json. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "jperceiver_tpu_torch", "ops", "cuda", "csrc", "reproj.cu")
HW = 1024


def variants(src: str) -> dict[str, str]:
    """The kernel's source and its variants, each derived by one textual
    change that must apply."""
    call_at = src.index("      k1_plane<T, L::PITCH>(")
    call = src[call_at:src.index("acc);", call_at) + len("acc);")]
    stage = "    if (k + 1 < NK) {\n      k1_stage"
    bound = "768 / K1Layout"
    out = {"kernel": src,
           "two_blocks_a_sm": src.replace(bound, "512 / K1Layout"),
           "four_blocks_a_sm": src.replace(bound, "1024 / K1Layout"),
           "staging_only": src.replace(call, "      (void)0;"),
           "arithmetic_only": src.replace(stage, "    if (k + 1 < NK && k < 0) {\n      k1_stage")}
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"chip_k1_sweep: the {name} variant no longer applies to reproj.cu")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k1_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import _levels, _tie_preds, parse_ptxas, time_ms
    from jperceiver_tpu_torch.ops.cuda import _build
    from jperceiver_tpu_torch.ops.cuda.reproj import reproj_min_plain
    from torch.utils.cpp_extension import CUDA_HOME

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    build = os.path.join(_build.BUILD_DIR, "k1_sweep")
    os.makedirs(build, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name, text in variants(open(SRC).read()).items():
        cu = os.path.join(build, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
             "-I", os.path.dirname(SRC), "-o", os.path.join(build, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{out}")
        regs[name] = [{k: r.get(k) for k in ("registers", "spill_stores")} | {"kernel": r["kernel"]}
                      for r in parse_ptxas(out) if "reproj_fwd" in r["kernel"] and "Li3ELi32E" in r["kernel"]]
        lib = ctypes.CDLL(os.path.join(build, f"{name}.so"))
        lib.jp_reproj_fwd.argtypes = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
        lib.jp_reproj_fwd.restype = ctypes.c_int
        libs[name] = lib

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        preds = _tie_preds(torch, g, (4, 1, 2, 3, HW, HW), dtype)
        ident = _levels(torch, g, (2, 1, 3, HW, HW)).to(dtype)
        targ = _levels(torch, g, (1, 3, HW, HW)).to(dtype)
        ref, ref_ident = reproj_min_plain(preds, targ), reproj_min_plain(ident[:, :, None], targ)
        out, ident_l = torch.empty_like(ref), torch.empty_like(ref_ident)
        code = torch.empty(ref.shape, dtype=torch.int16, device="cuda")
        for name, lib in libs.items():
            for th in ((32, 16, 8) if name == "kernel" else (32,)):
                def run(lib=lib, th=th):
                    err = lib.jp_reproj_fwd(
                        preds.data_ptr(), ident.data_ptr(), targ.data_ptr(), out.data_ptr(),
                        code.data_ptr(), ident_l.data_ptr(), 4, 1, 2, 2, 3, HW, HW, th,
                        1 if dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
                    _build.check(err, f"reproj_fwd ({name})")

                run()
                torch.cuda.synchronize()
                row = {"card": card, "variant": name, "dtype": str(dtype), "th": th,
                       "ms": [time_ms(torch, run) for _ in range(3)]}
                if name in ("kernel", "two_blocks_a_sm", "four_blocks_a_sm"):
                    row["max_abs_err"] = max((out - ref).abs().max().item(),
                                             (ident_l - ref_ident).abs().max().item())
                    if not row["max_abs_err"] <= 2e-5:
                        raise AssertionError(f"K1 disagrees with its plain version: {row}")
                rows.append(row)
                print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_sweep.json"), "w") as f:
        json.dump({"card": card, "ptxas": regs, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
