"""`device_idle_share.<entry>`: the share of the traced slice in which no
operation ran on the device, in %: 1 - (the union of the device
operations' intervals) / (the slice's wall time)."""


def read(ctx, metric):
    r = ctx.reduced
    if r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
