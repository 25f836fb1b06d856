"""Map the intensities onto [0, 1] in float32 (the JAX package's
``plugins/mapto01.py``)."""
import numpy as np


def execute(chunk):
    arr = np.asarray(chunk.host()).astype(np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        arr = (arr - lo) / (hi - lo)
    else:
        arr = np.zeros_like(arr)
    return arr
