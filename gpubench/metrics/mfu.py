"""The whole step's share of the cards' peak, in percent: twice the
model's multiply-accumulates per chunk (gpubench/yardstick/macs.py) times
the chunks completed in the untraced rest of the traced run's window, over
that time (host clock) times the peak of the configuration's precision
(gpubench/yardstick/peaks.py) times the cards."""

from gpubench.yardstick.macs import model_macs
from gpubench.yardstick.peaks import OPS_PER_S


def read(ctx):
    if ctx.window_s <= 0 or ctx.window_chunks <= 0:
        return None
    ops = 2.0 * model_macs(ctx.config) * ctx.window_chunks
    peak = OPS_PER_S[ctx.config["precision"]] * ctx.cards
    return 100.0 * ops / (ctx.window_s * peak)
