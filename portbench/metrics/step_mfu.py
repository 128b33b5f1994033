"""`step_mfu.<entry>`: the whole step's share of the chip's peak, in %: the
model FLOPs of the traced units (counted on the plain reference at the
cell's shapes, `flops.py`) over the traced slice's wall time, over the
dense tensor-core peak of the configuration's compute dtype
(`peaks.json`: TF32 for float32, whose convolutions cuDNN computes in
TF32 by default; bf16 for bfloat16)."""


def read(ctx, metric):
    r = ctx.reduced
    if r is None or r.window_s <= 0 or r.units <= 0:
        return None
    return 100.0 * ctx.work.flops * r.units / r.window_s / ctx.flops_per_s
