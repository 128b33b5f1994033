"""`conv_roofline.<entry>`: the convolutions' and matrix products' share of
their roofline, in %: the least time the chip could take for the traced
units' convolutions and matrix products (each at the larger of its FLOPs
over the compute dtype's peak, as `step_mfu` takes it, and its bytes over
the memory rate, `flops.py`), over
the device time of the kernels that `kernel_classes/conv.json` names."""

from portbench.flops import roofline_seconds


def read(ctx, metric):
    r = ctx.reduced
    if r is None or r.units <= 0:
        return None
    conv_s = r.by_class.get("conv", 0.0)
    if conv_s <= 0:
        return None
    bound = roofline_seconds(ctx.work, ctx.flops_per_s, ctx.hbm_bytes_per_s,
                             ctx.bytes_per_element)
    return 100.0 * bound * r.units / conv_s
