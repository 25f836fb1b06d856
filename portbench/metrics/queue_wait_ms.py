"""Milliseconds a chunk waits between the end of its staging
(``pipeline/stage``, on the prefetch thread) and the start of its
dispatch: its time in the prefetch queue and the ring, mean over the
window (the program's ``pipeline/queue_wait`` histogram)."""


def read(ctx):
    return ctx.span_ms("pipeline/queue_wait")
