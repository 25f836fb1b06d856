"""MRC2014 I/O without mrcfile: the counterpart of ``chunkflow_tpu/volume/io_mrc.py``.

The reference ``plugins/load_mrc.py`` calls mrcfile. MRC is a fixed
1024-byte header, an optional extended header and the raw voxels; the
subset EM stacks need reads and writes directly. The port also keeps a
chunk's voxel offset, in the header's NXSTART/NYSTART/NZSTART words (the
grid position of the first voxel), which the JAX package writes as 0 and
does not read.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_MODE_TO_DTYPE = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    3: np.complex64,   # int16 re/im; rarely used
    4: np.complex64,
    6: np.uint16,
    12: np.float16,
}


def load_mrc(path: str) -> Tuple[np.ndarray, dict]:
    """Read an MRC file -> (zyx array, header dict with voxel size in nm)."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz, mode = struct.unpack("<4i", header[0:16])
        mx, my, mz = struct.unpack("<3i", header[28:40])
        xlen, ylen, zlen = struct.unpack("<3f", header[40:52])
        nxstart, nystart, nzstart = struct.unpack("<3i", header[16:28])
        nsymbt = struct.unpack("<i", header[92:96])[0]
        f.seek(1024 + nsymbt)
        if mode not in _MODE_TO_DTYPE:
            raise ValueError(f"{path}: unsupported MRC mode {mode}")
        dtype = np.dtype(_MODE_TO_DTYPE[mode]).newbyteorder("<")
        data = np.fromfile(f, dtype=dtype, count=nx * ny * nz)
    array = data.reshape(nz, ny, nx)  # MRC stores x fastest -> zyx C order
    # cell dimensions are in angstrom; voxel size nm = len/10/grid
    voxel_size = tuple(
        (length / 10.0 / grid) if grid else 1.0
        for length, grid in ((zlen, mz), (ylen, my), (xlen, mx))
    )
    return array.copy(), {"voxel_size_nm": voxel_size, "mode": mode,
                          "voxel_offset": (nzstart, nystart, nxstart)}


def save_mrc(path: str, array, voxel_size_nm=(1.0, 1.0, 1.0),
             voxel_offset=(0, 0, 0)) -> str:
    """Write a minimal MRC2014 file (modes: int8/int16/float32/uint16;
    other dtypes are written as float32)."""
    from chunkflow_tpu_torch.chunk.base import as_native_dtype

    arr = np.ascontiguousarray(as_native_dtype(array))
    mode = {np.dtype(np.int8): 0, np.dtype(np.int16): 1,
            np.dtype(np.float32): 2, np.dtype(np.uint16): 6}.get(arr.dtype)
    if mode is None:
        arr = arr.astype(np.float32)
        mode = 2
    nz, ny, nx = arr.shape
    header = bytearray(1024)
    struct.pack_into("<4i", header, 0, nx, ny, nz, mode)
    struct.pack_into("<3i", header, 16, *(int(o) for o in
                                          reversed(tuple(voxel_offset))))
    struct.pack_into("<3i", header, 28, nx, ny, nz)
    struct.pack_into(
        "<3f", header, 40,
        nx * voxel_size_nm[2] * 10.0,
        ny * voxel_size_nm[1] * 10.0,
        nz * voxel_size_nm[0] * 10.0,
    )
    struct.pack_into("<3i", header, 64, 1, 2, 3)  # axis correspondence
    struct.pack_into(
        "<3f", header, 76,
        float(arr.min()), float(arr.max()), float(arr.mean())
    )
    header[208:212] = b"MAP "
    header[212:216] = bytes([0x44, 0x44, 0x00, 0x00])  # little-endian stamp
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return path
