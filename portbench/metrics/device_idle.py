"""Percent of the traced window in which no kernel ran on the card
(copies run on their own streams and do not count as work here)."""
import devtrace


def read(ctx):
    if not ctx.events or not ctx.trace_window_s:
        return None
    busy = devtrace.busy_us(ctx.events, kernels_only=True) / 1e6
    return 100.0 * (1.0 - busy / ctx.trace_window_s)
