"""Per-section median filter (the JAX package's
``plugins/median_filter.py``)."""
import numpy as np
from scipy import ndimage


def execute(chunk, size=3, mode: str = "reflect"):
    arr = np.asarray(chunk.host())
    if isinstance(size, (tuple, list)):
        kernel = tuple(size)
        # a (y, x) or (z, y, x) kernel padded on the left to the rank
        while len(kernel) < arr.ndim:
            kernel = (1,) + kernel
    else:
        kernel = (1, size, size) if arr.ndim == 3 else (1, 1, size, size)
    return ndimage.median_filter(arr, size=kernel, mode=mode)
