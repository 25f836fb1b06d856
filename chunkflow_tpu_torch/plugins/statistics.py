"""Print a chunk's statistics (the JAX package's
``plugins/statistics.py``)."""
import numpy as np


def execute(chunk):
    arr = np.asarray(chunk.host())
    print(
        f"chunk {chunk.bbox.string}: dtype={arr.dtype} "
        f"min={arr.min()} max={arr.max()} mean={arr.mean():.4f} "
        f"nonzero={np.count_nonzero(arr)}/{arr.size}"
    )
