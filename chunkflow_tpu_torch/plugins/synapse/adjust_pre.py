"""Snap each T-bar to the probability maximum in a small window around it
(the JAX package's ``plugins/synapse/adjust_pre.py``); the first maximum
in C order wins a tie."""
import numpy as np

from chunkflow_tpu_torch.annotations.synapses import Synapses


def execute(synapses, prob, window: int = 3):
    arr = np.asarray(prob.host())
    if arr.ndim == 4:
        arr = arr[0]
    offset = prob.voxel_offset.vec
    shape = np.asarray(arr.shape)
    adjusted = synapses.pre.copy()
    for i, point in enumerate(synapses.pre):
        local = point - offset
        lo = np.maximum(local - window, 0)
        hi = np.minimum(local + window + 1, shape)
        if np.any(lo >= hi):
            continue
        sub = arr[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        best = np.unravel_index(np.argmax(sub), sub.shape)
        adjusted[i] = lo + np.asarray(best) + offset
    return Synapses(
        adjusted,
        post=synapses.post,
        pre_confidence=synapses.pre_confidence,
        post_confidence=synapses.post_confidence,
        resolution=synapses.resolution,
    )
