"""Patch-parallel inference: the legacy entry over the mesh engine.

The counterpart of ``chunkflow_tpu/parallel/distributed.py``. Its
single-process path delegates to :mod:`chunkflow_tpu_torch.parallel.
engine` (``data=N``), bitwise one device. The psum program the JAX
module keeps for its multi-host recipe belongs to the multi-process
engine (ROADMAP, item 7b), which is not ported.
"""
from __future__ import annotations

import numpy as np


def sharded_inference(
    chunk_array: np.ndarray,
    engine,
    input_patch_size,
    output_patch_size,
    output_patch_overlap,
    batch_size: int = 1,
    devices=None,
    device="cuda",
):
    """Patch-parallel inference over ``devices`` (default: the local
    devices of ``device``, every card; ``device="cpu"`` runs on the
    CPU), delegating to the mesh engine; the result is a tensor on
    ``device``."""
    from chunkflow_tpu_torch.parallel.engine import (
        MeshSpec,
        mesh_devices,
        sharded_inference as unified,
    )

    devices = mesh_devices(devices, device)
    return unified(
        chunk_array, engine, input_patch_size, output_patch_size,
        output_patch_overlap, batch_size=batch_size,
        spec=MeshSpec("data", (len(devices),)), devices=devices,
        device=device,
    )
