"""`k3_roofline.<entry>`: K3's share of its roofline, in %: the least time
the card could take for the K3 launches (forward and data-grad) that the
program counted by shape across the traced slice (`Context.
launch_shapes`, each at the larger of its FLOPs over its dtype's peak and
its bytes over the memory rate, `phases.launch_work`), over the device
time of K3's kernels in the slice (`phases.conv_rooflines`). None where
the program counted no K3 launch or no K3 kernel ran."""

from portbench import spec
from portbench.phases import conv_rooflines


def read(ctx, metric):
    return conv_rooflines(ctx.events, ctx.window, ctx.launch_shapes, spec.peaks())["k3"]
