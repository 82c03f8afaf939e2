"""Device time of host-to-device copies per request (summed over the
cards), in milliseconds, from the device trace's memcpy events."""


def read(ctx):
    copies = [e for e in ctx.trace.copies if "HtoD" in e.name]
    if not copies:
        return None
    return sum(e.dur for e in copies) * 1e-3 / ctx.calls
