"""The readings that the limits of `limits/<cell>.json` are set from: for
each seed, a run of the cell with a short window, the program's numbers
against the plain reference and the control's (the reference in
bfloat16, `reference/model.py::precision`), all in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 --seconds 3 \
        [--out calibrate.jsonl]

Each seed's numbers are printed and, with `--out`, appended as a JSON line.
With `--fault <name>` a fault of `faults.py` is planted in the program and
the program's numbers are its readings (the control's are not kept).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None, help="a fault of faults.py planted in the program")
    args = p.parse_args(argv)

    import torch

    from portbench import faults, run

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        fault = faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with fault:
            res = run.run(args.workload, seed, args.seconds, False, t0=t0, controls=True,
                          log=lambda s: None)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "program": res["numbers"],
                "control": None if args.fault else res["controls"], "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
