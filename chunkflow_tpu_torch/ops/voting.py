"""Channel masking for multi-channel predictions.

The counterpart of ``mask_using_last_channel`` in
``chunkflow_tpu/ops/voting.py`` (reference chunk/base.py:685-689).
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk


def mask_using_last_channel(chunk: Chunk, threshold: float = 0.3) -> Chunk:
    """Zero out voxels where the last channel (e.g. myelin) exceeds
    ``threshold``, and drop that channel. Computes where the payload lies;
    a host payload stays a numpy array."""
    if chunk.ndim != 4:
        raise ValueError("needs a 4D (c, z, y, x) chunk")
    arr = chunk.array
    on_host = isinstance(arr, np.ndarray)
    if on_host:
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    mask = arr[-1] <= threshold
    out = arr[:-1] * mask[None].to(arr.dtype)
    if on_host:
        out = out.numpy()
    return Chunk(
        out,
        voxel_offset=chunk.voxel_offset,
        voxel_size=chunk.voxel_size,
        layer_type=chunk.layer_type,
    )
