"""NRRD I/O without pynrrd: the counterpart of ``chunkflow_tpu/volume/io_nrrd.py``.

The reference ``save-nrrd`` command (flow/flow.py:853) and its
``load_nrrd``/``save_nrrd`` plugins call pynrrd. NRRD's raw and gzip
encodings are a text header and a binary blob, read and written here
with numpy; the chunk offset rides in a ``chunkflow voxel offset`` key.
"""
from __future__ import annotations

import gzip
from typing import Optional, Tuple

import numpy as np

_NRRD_TO_NUMPY = {
    "signed char": "int8", "int8": "int8", "int8_t": "int8",
    "uchar": "uint8", "unsigned char": "uint8", "uint8": "uint8",
    "uint8_t": "uint8",
    "short": "int16", "int16": "int16", "int16_t": "int16",
    "ushort": "uint16", "uint16": "uint16", "uint16_t": "uint16",
    "int": "int32", "int32": "int32", "int32_t": "int32",
    "uint": "uint32", "uint32": "uint32", "uint32_t": "uint32",
    "longlong": "int64", "int64": "int64", "int64_t": "int64",
    "ulonglong": "uint64", "uint64": "uint64", "uint64_t": "uint64",
    "float": "float32", "float32": "float32",
    "double": "float64", "float64": "float64",
    "float16": "float16",
}


def save_nrrd(
    path: str,
    array: np.ndarray,
    voxel_size: Optional[Tuple[float, ...]] = None,
    voxel_offset: Optional[Tuple[int, ...]] = None,
    encoding: str = "raw",
) -> str:
    """Write an NRRD file. Axis order on disk follows NRRD convention
    (fastest axis first), so the zyx C-order array's sizes are reversed."""
    from chunkflow_tpu_torch.chunk.base import as_native_dtype

    arr = np.ascontiguousarray(as_native_dtype(array))
    sizes = " ".join(str(s) for s in reversed(arr.shape))
    lines = [
        "NRRD0004",
        "# generated by chunkflow-tpu",
        f"type: {arr.dtype.name}",
        f"dimension: {arr.ndim}",
        f"sizes: {sizes}",
        f"encoding: {encoding}",
        "endian: little",
    ]
    if voxel_size is not None and len(voxel_size) == arr.ndim:
        spacings = " ".join(str(float(s)) for s in reversed(tuple(voxel_size)))
        lines.append(f"spacings: {spacings}")
    if voxel_offset is not None and len(voxel_offset) == arr.ndim:
        # stash the zyx chunk offset so loads round-trip chunk placement
        offs = " ".join(str(int(o)) for o in voxel_offset)
        lines.append(f"chunkflow voxel offset:={offs}")
    header = "\n".join(lines) + "\n\n"
    blob = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    if encoding == "gzip":
        blob = gzip.compress(blob)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding: {encoding}")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(blob)
    return path


def load_nrrd(path: str):
    """Read an NRRD file -> (array, header_dict). Supports raw and gzip
    encodings, little endian."""
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.find(b"\n\n")
    if end < 0:
        raise ValueError(f"{path}: no NRRD header terminator")
    header: dict = {}
    for line in blob[:end].decode("ascii", errors="replace").splitlines()[1:]:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":=" in line:
            key, value = line.split(":=", 1)
        elif ":" in line:
            key, value = line.split(":", 1)
        else:
            continue
        header[key.strip()] = value.strip()

    dtype = np.dtype(_NRRD_TO_NUMPY[header["type"]])
    if header.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    sizes = [int(s) for s in header["sizes"].split()]
    shape = tuple(reversed(sizes))  # NRRD fastest-first -> C order
    data = blob[end + 2:]
    encoding = header.get("encoding", "raw")
    if encoding == "gzip":
        data = gzip.decompress(data)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding: {encoding}")
    array = np.frombuffer(data, dtype=dtype, count=int(np.prod(shape)))
    return array.reshape(shape).copy(), header  # flat -> C-order zyx
