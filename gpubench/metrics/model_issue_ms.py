"""Host time per request in the program's serve.model spans (every card's
block), in milliseconds: the host issuing the model."""

from gpubench.spans import MODEL, host_ms


def read(ctx):
    return host_ms(ctx, MODEL)
