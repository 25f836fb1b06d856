"""Invert the intensities (the JAX package's ``plugins/inverse.py``)."""
import numpy as np


def execute(chunk):
    arr = np.asarray(chunk.host())
    if np.dtype(arr.dtype).kind in "iu":
        return (np.iinfo(arr.dtype).max - arr).astype(arr.dtype)
    return (arr.max() - arr).astype(arr.dtype)
