"""Thresholding: the counterpart of ``chunkflow_tpu/ops/threshold.py``.

A host payload compares with numpy, as the JAX package does; a tensor
payload compares in torch where it lies, in the dtype numpy would
compare in (``core/ufuncs.py``), so both give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.core import ufuncs
from chunkflow_tpu_torch.core.dtypes import torch_dtype


def threshold(chunk: Chunk, value: float, dtype=np.uint8) -> Chunk:
    """Binarize a probability/affinity chunk at ``value``."""
    arr = chunk.array
    if isinstance(arr, torch.Tensor):
        arr = ufuncs.apply(np.greater, arr, value).to(torch_dtype(dtype))
    else:
        arr = (np.asarray(arr) > value).astype(dtype)
    return Chunk(
        arr,
        voxel_offset=chunk.voxel_offset,
        voxel_size=chunk.voxel_size,
        layer_type=(LayerType.PROBABILITY_MAP if np.dtype(dtype).kind == "f"
                    else LayerType.IMAGE),
    )
