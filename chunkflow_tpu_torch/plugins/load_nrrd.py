"""Load an NRRD file as a chunk (the JAX package's
``plugins/load_nrrd.py``)."""
from chunkflow_tpu_torch.chunk import Chunk
from chunkflow_tpu_torch.volume.io_nrrd import load_nrrd


def execute(file_name: str, voxel_offset=None, voxel_size=None):
    array, header = load_nrrd(file_name)
    if voxel_offset is None and "chunkflow voxel offset" in header:
        voxel_offset = tuple(
            int(v) for v in header["chunkflow voxel offset"].split()
        )
    return Chunk(array, voxel_offset=voxel_offset, voxel_size=voxel_size)
