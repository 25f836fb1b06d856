"""Load an MRC file as an image chunk (the JAX package's
``plugins/load_mrc.py``)."""
from chunkflow_tpu_torch.chunk import Image
from chunkflow_tpu_torch.volume.io_mrc import load_mrc


def execute(file_name: str, voxel_offset=None):
    array, header = load_mrc(file_name)
    return Image(
        array,
        voxel_offset=voxel_offset,
        voxel_size=tuple(max(1, round(s)) for s in header["voxel_size_nm"]),
    )
