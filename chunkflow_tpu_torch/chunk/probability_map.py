"""Probability map chunk: the counterpart of ``chunkflow_tpu/chunk/probability_map.py``.

Peak detection on the host, as the JAX package: a
``scipy.ndimage.maximum_filter`` non-max suppression.
"""
from __future__ import annotations

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, as_native_dtype


class ProbabilityMap(Chunk):
    def __init__(self, array, **kwargs):
        kwargs.setdefault("layer_type", LayerType.PROBABILITY_MAP)
        super().__init__(array, **kwargs)

    @classmethod
    def from_chunk(cls, chunk: Chunk) -> "ProbabilityMap":
        return cls(
            chunk.array,
            voxel_offset=chunk.voxel_offset,
            voxel_size=chunk.voxel_size,
        )

    def detect_points(
        self,
        min_distance: int = 15,
        threshold_rel: float = 0.3,
    ):
        """Local maxima in global voxel coordinates with confidences.

        Returns (points Nx3 int array in global zyx, confidences N floats).
        """
        from scipy import ndimage

        arr = as_native_dtype(self.array)
        if arr.ndim == 4:
            arr = arr[0]
        size = 2 * min_distance + 1
        local_max = ndimage.maximum_filter(arr, size=size, mode="constant")
        threshold = threshold_rel * float(arr.max()) if arr.size else 0.0
        peaks = np.logical_and(arr == local_max, arr > threshold)
        coords = np.argwhere(peaks)
        confidences = (arr[tuple(coords.T)] if coords.size
                       else np.zeros((0,), dtype=arr.dtype))
        coords = coords + self.voxel_offset.vec
        return coords.astype(np.int64), confidences
