"""Card idle time per request while the host issues the model, in
milliseconds: each card's idle intervals in the traced window (no kernel,
copy or memset) intersected with the union of the program's serve.model
spans, summed over the cards (a card with no device event counts as idle
throughout)."""

from gpubench.spans import MODEL, complement, intersect, length, named


def read(ctx):
    tr = ctx.trace
    devices = tr.devices()
    spans = named(tr, MODEL)
    if not devices or not spans:
        return None
    t0, t1 = tr.window()
    model = intersect([(s.ts, s.end) for s in spans], [(t0, t1)])
    idle = sum(length(intersect(complement(tr.busy_intervals(d), t0, t1), model))
               for d in devices)
    idle += (max(ctx.cards, len(devices)) - len(devices)) * length(model)
    return idle * 1e-3 / ctx.calls
