"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    if ctx.device != "cuda":
        return None
    return ctx.peak_window / 2**30
