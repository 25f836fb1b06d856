"""The gather kernel's share of its roofline (bytes: each uint8 patch
element read once and written once as float32), from the traced
window."""
import devtrace


def read(ctx):
    if not ctx.events:
        return None
    return devtrace.roofline_share(ctx.events, "gather",
                                   ctx.costs["kernels"]["gather"])
