"""Stretch the contrast between two percentiles (the JAX package's
``plugins/stretch_intensity.py``)."""
import numpy as np


def execute(chunk, low_percentile: float = 1.0, high_percentile: float = 99.0):
    src = np.asarray(chunk.host())
    arr = src.astype(np.float32)
    lo = np.percentile(arr, low_percentile)
    hi = np.percentile(arr, high_percentile)
    dtype = src.dtype
    out_max = np.iinfo(dtype).max if np.dtype(dtype).kind in "iu" else 1.0
    out = np.clip((arr - lo) / max(hi - lo, 1e-6) * out_max, 0, out_max)
    return out.astype(dtype)
