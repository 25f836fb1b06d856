"""Device milliseconds per chunk of every kernel that is not the gather,
the accumulate, a copy or a memset (the convnet's kernels, the blend's
zero fills and the normalization), from the traced window. The chunks
traced are the gather's launches over its launches per chunk."""
import devtrace


def read(ctx):
    if not ctx.events:
        return None
    launches, _ = devtrace.kernel_time(ctx.events, "gather_kernel")
    if not launches:
        return None
    chunks = launches / ctx.costs["kernels"]["gather"]["launches"]
    other = sum(e - s for name, s, e in ctx.events
                if not devtrace.is_copy(name)
                and "gather_kernel" not in name
                and "accumulate_kernel" not in name)
    return other / 1e3 / chunks
