"""Host milliseconds per chunk in the executor's dispatch
(``pipeline/dispatch`` spans: enqueueing a chunk's kernels), mean over
the window."""


def read(ctx):
    return ctx.span_ms("pipeline/dispatch")
