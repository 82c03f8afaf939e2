"""Device time per request (summed over the cards) of the kernels launched
inside the program's serve.model spans, each around one card's model call,
in milliseconds."""

from gpubench.spans import MODEL


def read(ctx):
    kernels = ctx.trace.launched_in(MODEL)
    if not kernels:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / ctx.calls
