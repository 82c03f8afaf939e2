"""The INT8 executor's computed ops per request: the program's tflite.<OP>
spans over the requests (every card's block). A count that repeats
exactly."""

from gpubench.spans import OP_PREFIX


def read(ctx):
    ops = sum(s.name.startswith(OP_PREFIX) for s in ctx.trace.spans)
    if not ops:
        return None
    return ops / ctx.calls
