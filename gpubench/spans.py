"""The program's own spans in a traced run, and the interval arithmetic the
readers of them need.

The port records these spans while a torch profiler records
(birdnet_stm32_tpu_torch/utils/tracing.py; the names are repeated here
because the readers import nothing of the port): serve.request around one
classify call, holding serve.ingress, serve.frontend and serve.model for
each card's block, and serve.egress; tflite.<OP> around each computed op
of the INT8 executor. A program without them leaves every reader of them
with nothing to read.

Intervals are (start, end) pairs in microseconds on the trace's one clock.
"""

from __future__ import annotations

REQUEST = "serve.request"
INGRESS = "serve.ingress"
FRONTEND = "serve.frontend"
MODEL = "serve.model"
EGRESS = "serve.egress"
OP_PREFIX = "tflite."


def named(trace, name: str) -> list:
    return [s for s in trace.spans if s.name == name]


def host_ms(ctx, name: str):
    """Host time per request inside the spans of that name, in
    milliseconds; None when the run has none."""
    spans = named(ctx.trace, name)
    if not spans:
        return None
    return sum(s.dur for s in spans) * 1e-3 / ctx.calls


def merged(pairs) -> list:
    """The union of the intervals, as sorted disjoint [start, end] pairs."""
    out = []
    for a, b in sorted(map(tuple, pairs)):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def length(pairs) -> float:
    return sum(b - a for a, b in merged(pairs))


def intersect(xs, ys) -> list:
    """The intersection of two unions of intervals (each merged first)."""
    xs, ys = merged(xs), merged(ys)
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(pairs, t0: float, t1: float) -> list:
    """The parts of [t0, t1] that no interval covers."""
    out, at = [], t0
    for a, b in intersect(pairs, [(t0, t1)]):
        if a > at:
            out.append([at, a])
        at = b
    if t1 > at:
        out.append([at, t1])
    return out
