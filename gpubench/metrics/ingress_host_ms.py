"""Host time per request in the program's serve.ingress spans, in
milliseconds: the host-to-device copies, a pageable copy's staging
included, and the issue of the dequantize and resample."""

from gpubench.spans import INGRESS, host_ms


def read(ctx):
    return host_ms(ctx, INGRESS)
