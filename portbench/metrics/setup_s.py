"""Seconds from the process's start to the first timed task: imports,
kernels from the build cache (built on a checkout's first run), seeded
weights and data, the program's set-up and the warm-up tasks."""


def read(ctx):
    return ctx.setup_s
