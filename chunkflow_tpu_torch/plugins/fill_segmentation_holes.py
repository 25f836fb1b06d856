"""Fill the interior holes of every object (the JAX package's
``plugins/fill_segmentation_holes.py``)."""
import numpy as np
from scipy import ndimage


def execute(seg):
    arr = np.asarray(seg.host())
    out = arr.copy()
    for obj_id in np.unique(arr):
        if obj_id == 0:
            continue
        mask = arr == obj_id
        filled = ndimage.binary_fill_holes(mask)
        out[np.logical_and(filled, ~mask)] = obj_id
    return out
