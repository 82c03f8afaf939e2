"""The MBConv 1x1 expand and project convolutions' share of their
roofline, in percent: their operations per request (gpubench/yardstick/
macs_efficientnet.py::pointwise_flops) at the peak of the configuration's
precision (gpubench/yardstick/peaks.py), over the device time per request
of the kernels launched inside the program's mbconv.expand and
mbconv.project spans, summed over the cards."""

from gpubench.yardstick.macs_efficientnet import pointwise_flops
from gpubench.yardstick.peaks import OPS_PER_S

SPANS = ("mbconv.expand", "mbconv.project")


def read(ctx):
    kernels = [k for name in SPANS for k in ctx.trace.launched_in(name)]
    if not kernels:
        return None
    least_s = pointwise_flops(ctx.config, ctx.rows) / OPS_PER_S[ctx.config["precision"]]
    device_s = sum(k.dur for k in kernels) * 1e-6 / ctx.calls
    return 100.0 * least_s / device_s
