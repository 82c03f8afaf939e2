"""The share of the traced window in which a card ran no kernel, copy or
memset, in percent; over several cards the mean of the cards (a card with
no device event counts as idle throughout)."""


def read(ctx):
    devices = ctx.trace.devices()
    if not devices:
        return None
    t0, t1 = ctx.trace.window()
    busy = sum(ctx.trace.busy_us(d) for d in devices) / (t1 - t0)
    return 100.0 * (1.0 - busy / max(ctx.cards, len(devices)))
