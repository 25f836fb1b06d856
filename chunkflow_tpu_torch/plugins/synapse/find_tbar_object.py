"""The segment id under each T-bar, as a 1-D array (the JAX package's
``plugins/synapse/find_tbar_object.py``)."""
import numpy as np


def execute(synapses, seg):
    arr = np.asarray(seg.host())
    if arr.ndim == 4:
        arr = arr[0]
    offset = seg.voxel_offset.vec
    shape = np.asarray(arr.shape)
    ids = np.zeros(synapses.pre_num, dtype=arr.dtype)
    for i, point in enumerate(synapses.pre):
        local = point - offset
        if np.all(local >= 0) and np.all(local < shape):
            ids[i] = arr[tuple(local)]
    print(f"{np.count_nonzero(ids)}/{ids.size} T-bars on labeled objects")
    return ids
