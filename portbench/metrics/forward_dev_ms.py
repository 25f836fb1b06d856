"""Device milliseconds per chunk of its forwards alone, timed inside the
program by a pair of CUDA events around each batch's forward (the
program's ``inference/forward_device`` histogram), mean over the
window."""


def read(ctx):
    return ctx.span_ms("inference/forward_device")
