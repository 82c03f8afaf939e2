"""Device time per request (summed over the cards) of the kernels launched
inside the program's mbconv.se spans, each around one MBConv block's whole
squeeze-and-excite (pool, both dense layers, their activations and the
product), in milliseconds."""

SPAN = "mbconv.se"


def read(ctx):
    kernels = ctx.trace.launched_in(SPAN)
    if not kernels:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / ctx.calls
