"""The MBConv depthwise convolutions' share of their roofline, in percent:
the bytes they must move per request (gpubench/yardstick/macs_efficientnet.py::
depthwise_bytes: each block's input read and output written once per chunk,
its weights once per card, at the configuration's precision) at the HBM
peak, over the device time per request of the kernels launched inside the
program's mbconv.dw spans (the padding's copy included), summed over the
cards."""

from gpubench.yardstick.macs_efficientnet import depthwise_bytes
from gpubench.yardstick.peaks import HBM_BYTES_PER_S

SPAN = "mbconv.dw"


def read(ctx):
    kernels = ctx.trace.launched_in(SPAN)
    if not kernels:
        return None
    least_s = ctx.cards * depthwise_bytes(ctx.config, ctx.rows // ctx.cards) / HBM_BYTES_PER_S
    device_s = sum(k.dur for k in kernels) * 1e-6 / ctx.calls
    return 100.0 * least_s / device_s
