"""The INT8 executor's hand-written convolution kernels per request: device
kernels whose name starts with `int8_conv` (the port's
ops/csrc/int8_conv_kernel.cu; the prefix is repeated here because the
readers import nothing of the port) launched inside the program's
serve.model spans, summed over the cards. On one card it reads 23 on the
flagship graph when every body convolution runs its kernel, and 0 where
the model's kernels are all others, as in a program without them. A count
that repeats exactly. It says whether the kernels engaged: a program that
fuses more of the body into fewer `int8_conv` launches reads lower, and
that is no regression (`model_busy_ms` and `chunks_per_s` judge it)."""

from gpubench.spans import MODEL

PREFIX = "int8_conv"


def read(ctx):
    kernels = ctx.trace.launched_in(MODEL)
    if not kernels:
        return None
    return sum(k.name.removeprefix("void ").startswith(PREFIX) for k in kernels) / ctx.calls
