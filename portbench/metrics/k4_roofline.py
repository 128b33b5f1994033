"""`k4_roofline.<entry>`: K4's (the 3x3 weight gradient's) share of its
roofline, in %, as `k3_roofline` takes K3's: the least time for the K4
launches the program counted by shape across the traced slice, over the
device time of K4's kernels (its split sums included) in the slice. None
where the program counted no K4 launch or no K4 kernel ran."""

from portbench import spec
from portbench.phases import conv_rooflines


def read(ctx, metric):
    return conv_rooflines(ctx.events, ctx.window, ctx.launch_shapes, spec.peaks())["k4"]
