"""Host milliseconds per task in the save operator
(``op/save-precomputed`` spans), mean over the window."""


def read(ctx):
    return ctx.span_ms("op/save-precomputed")
