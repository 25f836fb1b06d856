"""The whole step's share of the card's peak: the convolution FLOPs of
the patches the tasks finished in the window needed (filler patches not
counted; ``reference/counts.py``), over the window's seconds times the
configuration dtype's dense peak (989 TFLOP/s in bfloat16)."""


def read(ctx):
    if not ctx.over():
        return None
    flops = len(ctx.tasks) * ctx.costs["flops_per_task"]
    return 100.0 * flops / (ctx.window_s * ctx.costs["peak_flops"])
