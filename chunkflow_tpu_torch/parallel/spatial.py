"""Sharding in y slabs: the legacy entry over the mesh engine.

The counterpart of ``chunkflow_tpu/parallel/spatial.py``: the chunk lives
in y slabs with halo exchange (the mesh engine's ``y=N``), and the blend
is replayed in reference order, bitwise one device. The slab geometry
stays here for callers that size slabs with it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Triple = Tuple[int, int, int]


def spatial_geometry(y: int, n_devices: int, pin: Triple, pout: Triple):
    """(slab, halo_left, halo_right, spill, padded_y) for y-sharding:
    the slab is the even split rounded up to the halo and spill minimum;
    callers zero-pad y to ``padded_y = slab * n_devices`` and crop back
    (the mesh engine derives the same numbers through
    ``engine.axis_geometry``)."""
    margin_y = (pin[1] - pout[1]) // 2
    halo_left = margin_y
    halo_right = pin[1] - margin_y
    spill = pout[1]
    slab = max(-(-y // n_devices), halo_left, halo_right, spill)
    padded_y = slab * n_devices
    return slab, halo_left, halo_right, spill, padded_y


def pad_chunk_y(arr, padded_y: int):
    """Zero-pad ``[C, Z, y, X]`` on the high side of y to ``padded_y``
    (numpy arrays and tensors alike)."""
    y = arr.shape[-2]
    if y == padded_y:
        return arr
    if isinstance(arr, np.ndarray):
        pad = [(0, 0)] * arr.ndim
        pad[-2] = (0, padded_y - y)
        return np.pad(arr, pad)
    out = arr.new_zeros(tuple(arr.shape[:-2]) + (padded_y, arr.shape[-1]))
    out[..., :y, :] = arr
    return out


def spatial_sharded_inference(
    chunk_array,
    engine,
    input_patch_size: Triple,
    output_patch_size: Triple,
    output_patch_overlap: Triple,
    batch_size: int = 1,
    devices=None,
    device="cuda",
):
    """Inference with the chunk sharded in y over ``devices`` (default:
    the local devices of ``device``, every card; ``device="cpu"`` runs
    on the CPU), delegating to the mesh engine (``y=N``); one device is
    the trivial ``data`` mesh. The result is a tensor on ``device``."""
    from chunkflow_tpu_torch.parallel.engine import (
        MeshSpec,
        mesh_devices,
        sharded_inference,
    )

    devices = mesh_devices(devices, device)
    n_dev = len(devices)
    spec = (MeshSpec("spatial", (n_dev, 1)) if n_dev > 1
            else MeshSpec("data", (1,)))
    return sharded_inference(
        chunk_array, engine, input_patch_size, output_patch_size,
        output_patch_overlap, batch_size=batch_size, spec=spec,
        devices=devices, device=device,
    )
