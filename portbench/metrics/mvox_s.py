"""Output voxels (one per voxel, not per channel) of the tasks finished
inside the window, per second of the window, in millions: the window
runs from one task's finish to another's, so it holds whole tasks."""


def read(ctx):
    if not ctx.over():
        return None
    return len(ctx.tasks) * ctx.costs["output_voxels"] / ctx.window_s / 1e6
