"""Device time per request (summed over the cards) of the kernels launched
inside the benchmark's span around the runner's per-card model call, in
milliseconds."""

from gpubench.trace import MODEL_SPAN


def read(ctx):
    kernels = ctx.trace.launched_in(MODEL_SPAN)
    if not kernels:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / ctx.calls
