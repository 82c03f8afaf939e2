"""The serving entry's own host time per request, in milliseconds: each
program serve.request span's duration less the union of the spans it
contains on its thread (ingress, frontend, model, egress and what they
hold), overlaps counted once."""

from gpubench.spans import REQUEST, length, named


def read(ctx):
    requests = named(ctx.trace, REQUEST)
    if not requests:
        return None
    own = 0.0
    for r in requests:
        inner = [(s.ts, s.end) for s in ctx.trace.spans
                 if s.tid == r.tid and s.dur < r.dur and s.ts >= r.ts and s.end <= r.end]
        own += r.dur - length(inner)
    return own * 1e-3 / ctx.calls
