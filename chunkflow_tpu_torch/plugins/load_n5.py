"""Load a chunk from an N5 dataset (the JAX package's
``plugins/load_n5.py``, which reads through tensorstore): the bbox
indexes the dataset's first three dimensions, the rest are read whole.
Raw and gzip blocks (``volume/zarr.py``); ``cache`` is accepted and
unused (the port keeps no block cache for N5)."""
import os

from chunkflow_tpu_torch.chunk import Chunk
from chunkflow_tpu_torch.volume.zarr import open_array


def execute(bbox, n5_dir: str = None, group_path: str = None,
            voxel_size: tuple = None, cache: int = None):
    store = open_array(os.path.join(n5_dir, group_path or ""), "n5")
    return Chunk(
        store.read(bbox.slices),
        voxel_offset=bbox.start,
        voxel_size=voxel_size if voxel_size is not None else (1, 1, 1),
    )
