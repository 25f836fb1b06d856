"""Channel voting and masking for multi-channel predictions.

The counterpart of ``chunkflow_tpu/ops/voting.py`` (reference
chunk/base.py:672-689). The JAX package computes both with ``jnp``
wherever the chunk lives; the port computes in torch where the payload
lies (``channel_voting`` of a host chunk: on the caller's ``device``,
the result back on the host).
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.ops.mask import jnp_payload


def channel_voting(chunk: Chunk, device="cuda") -> Chunk:
    """argmax over channels + 1 (label 0 reserved for background), as
    uint8; ties go to the first channel, as ``jnp.argmax``."""
    if chunk.ndim != 4:
        raise ValueError("channel voting needs a 4D (c, z, y, x) chunk")
    on_host = not isinstance(chunk.array, torch.Tensor)
    arr = jnp_payload(chunk, device)
    out = (torch.argmax(arr, dim=0) + 1).to(torch.uint8)
    if on_host:
        out = out.cpu().numpy()
    return Chunk(
        out,
        voxel_offset=chunk.voxel_offset,
        voxel_size=chunk.voxel_size,
        layer_type=LayerType.SEGMENTATION,
    )


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
