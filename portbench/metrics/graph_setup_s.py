"""`graph_setup_s`: the set-up seconds that the program spent in its CUDA
graphs' eager warm-ups and captures and in building or loading its kernel
library, as it timed them itself (`jperceiver_tpu_torch/tracing.py`,
`totals()`: the events `graph.eager`, `graph.capture` and `kernels.build`,
each second counted once where one runs inside another). Every shape is
warmed up in set-up, so the totals read after the window are set-up's.
None where the program has no such timer."""

import sys

from portbench.phases import setup_seconds


def read(ctx, metric):
    tracing = sys.modules.get("jperceiver_tpu_torch.tracing")
    return None if tracing is None else setup_seconds(tracing.totals())
