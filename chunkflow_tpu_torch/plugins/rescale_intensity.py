"""Rescale the intensities linearly onto the dtype's full range (the JAX
package's ``plugins/rescale_intensity.py``)."""
import numpy as np


def execute(chunk, low: float = None, high: float = None):
    src = np.asarray(chunk.host())
    arr = src.astype(np.float32)
    lo = float(arr.min()) if low is None else low
    hi = float(arr.max()) if high is None else high
    dtype = src.dtype
    if np.dtype(dtype).kind in "iu":
        out_max = np.iinfo(dtype).max
    else:
        out_max = 1.0
    scale = out_max / max(hi - lo, 1e-6)
    out = np.clip((arr - lo) * scale, 0, out_max)
    return out.astype(dtype)
