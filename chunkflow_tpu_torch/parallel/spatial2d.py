"""Sharding over a (y, x) grid: the legacy entry over the mesh engine.

The counterpart of ``chunkflow_tpu/parallel/spatial2d.py``: the chunk
lives on a (y, x) grid of devices with two-phase halo exchange (the mesh
engine's ``y=A,x=B``), bitwise one device. The mesh-shape helper stays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Triple = Tuple[int, int, int]


def near_square_shape(n: int) -> Tuple[int, int]:
    """The default (ny, nx) factorization of ``n`` devices: the most
    square split with ny <= sqrt(n) (the ``sharding='spatial2d'``
    layout)."""
    ny = int(np.floor(np.sqrt(n)))
    while n % ny:
        ny -= 1
    return ny, n // ny


def spatial2d_sharded_inference(
    chunk_array,
    engine,
    input_patch_size: Triple,
    output_patch_size: Triple,
    output_patch_overlap: Triple,
    batch_size: int = 1,
    devices=None,
    shape: Tuple[int, int] = None,
    device="cuda",
):
    """Inference with the chunk sharded over a (y, x) grid of
    ``devices`` (default: the local devices of ``device``, every card;
    ``device="cpu"`` runs on the CPU; the grid defaults to
    :func:`near_square_shape`), delegating to the mesh engine
    (``y=A,x=B``). The result is a tensor on ``device``."""
    from chunkflow_tpu_torch.parallel.engine import (
        MeshSpec,
        mesh_devices,
        sharded_inference,
    )

    devices = mesh_devices(devices, device)
    if shape is None:
        shape = near_square_shape(len(devices))
    ny, nx = shape
    spec = (MeshSpec("spatial", (ny, nx)) if ny * nx > 1
            else MeshSpec("data", (1,)))
    return sharded_inference(
        chunk_array, engine, input_patch_size, output_patch_size,
        output_patch_overlap, batch_size=batch_size, spec=spec,
        devices=devices, device=device,
    )
