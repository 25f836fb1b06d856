"""Multi-page TIFF I/O through Pillow: the counterpart of ``chunkflow_tpu/volume/io_tif.py``.

z-sections map to TIFF pages (reference chunk/base.py from_tif/to_tif).
A card payload is downloaded once; bfloat16 widens to float32.
"""
from __future__ import annotations

import numpy as np
from PIL import Image as PILImage

_COMPRESSION = {
    None: None, "raw": None, "none": None,
    "zlib": "tiff_deflate", "deflate": "tiff_deflate",
    "lzw": "tiff_lzw", "packbits": "packbits",
}


def write_tif(chunk, path: str, compression: str = "zlib") -> str:
    from chunkflow_tpu_torch.chunk.base import as_native_dtype

    arr = as_native_dtype(chunk.array)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError("TIFF export supports single-channel chunks only")
        arr = arr[0]
    pages = [PILImage.fromarray(section) for section in arr]
    comp = _COMPRESSION.get(compression, compression)
    kwargs = {"compression": comp} if comp else {}
    pages[0].save(path, save_all=True, append_images=pages[1:], **kwargs)
    return path


def read_tif(path: str, voxel_offset=None, voxel_size=None, dtype=None):
    from chunkflow_tpu_torch.chunk.base import Chunk

    sections = []
    with PILImage.open(path) as img:
        try:
            while True:
                sections.append(np.asarray(img))
                img.seek(img.tell() + 1)
        except EOFError:
            pass
    arr = np.stack(sections, axis=0)
    if dtype is not None:
        arr = arr.astype(dtype)
    return Chunk(arr, voxel_offset=voxel_offset, voxel_size=voxel_size)
