"""Host milliseconds per task to commit it (``lifecycle/commit`` spans:
the wait for its durable writes, the ledger mark, the ack), mean over
the window."""


def read(ctx):
    return ctx.span_ms("lifecycle/commit")
