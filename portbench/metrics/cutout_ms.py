"""Host milliseconds of block reads per task: the ``storage/read`` spans
of the window summed, over the tasks cut out in it
(``op/load-precomputed`` spans)."""


def read(ctx):
    reads = ctx.spans.get("storage/read")
    tasks = ctx.spans.get("op/load-precomputed")
    if not reads or not tasks:
        return None
    return reads["total"] / tasks["count"] * 1e3
