"""The accumulate kernel's share of its roofline (bytes: predictions and
bump read once, every covered output and weight cell read and written
once), from the traced window."""
import devtrace


def read(ctx):
    if not ctx.events:
        return None
    return devtrace.roofline_share(ctx.events, "accumulate",
                                   ctx.costs["kernels"]["accumulate"])
