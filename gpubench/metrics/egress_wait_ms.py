"""Host time per request in the program's serve.egress spans, in
milliseconds: the wait for the card's tail of the request plus the scores'
copy to the host (or their gather)."""

from gpubench.spans import EGRESS, host_ms


def read(ctx):
    return host_ms(ctx, EGRESS)
