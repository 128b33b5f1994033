"""`elementwise_ms.<entry>`: device milliseconds a unit (a step, a request,
a streaming call) of the kernels the class files put among ATen's
elementwise, normalisation, reduction and copy kernels."""

CLASSES = ("elementwise", "normalization", "reduction", "copy")


def read(ctx, metric):
    r = ctx.reduced
    if r is None or r.units <= 0:
        return None
    total = sum(r.by_class.get(c, 0.0) for c in CLASSES)
    if total <= 0:
        return None
    return 1e3 * total / r.units
