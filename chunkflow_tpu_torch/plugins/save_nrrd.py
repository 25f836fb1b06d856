"""Save a chunk as an NRRD file (the JAX package's
``plugins/save_nrrd.py``)."""
import numpy as np

from chunkflow_tpu_torch.volume.io_nrrd import save_nrrd


def execute(chunk, file_name: str = "chunk.nrrd"):
    save_nrrd(
        file_name,
        np.asarray(chunk.host()),
        voxel_size=tuple(chunk.voxel_size),
        voxel_offset=tuple(chunk.voxel_offset),
    )
    print(f"saved chunk to {file_name}")
