"""Neuroglancer precomputed volumes with ``raw`` blocks, on local disk.

The format, from its specification: an ``info`` JSON file, and one file
per block of each scale, named ``<key>/<x0>-<x1>_<y0>-<y1>_<z0>-<z1>`` in
voxel coordinates, the block grid anchored at the scale's
``voxel_offset`` and edge blocks clipped to the volume. A raw block holds
every channel, little-endian, x fastest then y, z and the channel (C
order of ``[c, z, y, x]``). Sizes, offsets and resolutions in ``info``
are x, y, z; the functions here take z, y, x.
"""
from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np


def write_info(path: str, size, voxel_size, offset, block, channels: int,
               dtype: str) -> None:
    os.makedirs(path, exist_ok=True)
    rz, ry, rx = voxel_size
    scale = {
        "key": f"{rx}_{ry}_{rz}",
        "size": list(reversed([int(v) for v in size])),
        "resolution": [rx, ry, rz],
        "voxel_offset": list(reversed([int(v) for v in offset])),
        "chunk_sizes": [list(reversed([int(v) for v in block]))],
        "encoding": "raw",
    }
    info = {"type": "image", "data_type": dtype, "num_channels": channels,
            "scales": [scale]}
    with open(os.path.join(path, "info"), "w") as f:
        json.dump(info, f)


def _scale(path: str) -> Tuple[dict, dict]:
    with open(os.path.join(path, "info")) as f:
        info = json.load(f)
    return info, info["scales"][0]


def _name(lo, hi) -> str:
    (z0, y0, x0), (z1, y1, x1) = lo, hi
    return f"{x0}-{x1}_{y0}-{y1}_{z0}-{z1}"


def write_tiled(path: str, base: np.ndarray, tiles_x: int) -> None:
    """Write ``base`` (``[z, y, x]``, a whole number of blocks on each
    axis, offset 0) as the volume's first ``base.shape[2]`` voxels in x,
    and hard-link its block files ``tiles_x - 1`` more times along x: the
    volume is ``base`` repeated in x at no further bytes on disk."""
    info, scale = _scale(path)
    key = os.path.join(path, scale["key"])
    os.makedirs(key, exist_ok=True)
    bx, by, bz = scale["chunk_sizes"][0]
    Z, Y, X = base.shape
    for z in range(0, Z, bz):
        for y in range(0, Y, by):
            for x in range(0, X, bx):
                lo, hi = (z, y, x), (z + bz, y + by, x + bx)
                first = os.path.join(key, _name(lo, hi))
                block = np.ascontiguousarray(base[z:z + bz, y:y + by,
                                                  x:x + bx])
                with open(first, "wb") as f:
                    f.write(block.astype(block.dtype.newbyteorder("<"))
                            .tobytes())
                for t in range(1, tiles_x):
                    shift = t * X
                    os.link(first, os.path.join(key, _name(
                        (z, y, x + shift), (z + bz, y + by, x + bx + shift))))


def read(path: str, start: Sequence[int], size: Sequence[int]) -> np.ndarray:
    """``[c, z, y, x]`` of the box; a missing block reads as zeros."""
    info, scale = _scale(path)
    dtype = np.dtype(info["data_type"]).newbyteorder("<")
    channels = info["num_channels"]
    block = tuple(reversed(scale["chunk_sizes"][0]))
    offset = tuple(reversed(scale["voxel_offset"]))
    extent = tuple(o + s for o, s in zip(offset,
                                         reversed(scale["size"])))
    key = os.path.join(path, scale["key"])
    start = tuple(int(v) for v in start)
    stop = tuple(a + int(s) for a, s in zip(start, size))
    out = np.zeros((channels,) + tuple(int(s) for s in size), dtype=dtype)
    ranges = [range((a - o) // b, -(-(e - o) // b))
              for a, e, o, b in zip(start, stop, offset, block)]
    for iz in ranges[0]:
        for iy in ranges[1]:
            for ix in ranges[2]:
                idx = (iz, iy, ix)
                lo = tuple(o + i * b for o, i, b in zip(offset, idx, block))
                hi = tuple(min(a + b, e) for a, b, e in zip(lo, block,
                                                             extent))
                name = os.path.join(key, _name(lo, hi))
                if not os.path.exists(name):
                    continue
                shape = (channels,) + tuple(h - l for l, h in zip(lo, hi))
                with open(name, "rb") as f:
                    data = np.frombuffer(f.read(), dtype=dtype)
                data = data.reshape(shape)
                src = tuple(slice(max(a, l) - l, min(e, h) - l)
                            for a, e, l, h in zip(start, stop, lo, hi))
                dst = tuple(slice(max(a, l) - a, min(e, h) - a)
                            for a, e, l, h in zip(start, stop, lo, hi))
                out[(slice(None),) + dst] = data[(slice(None),) + src]
    return out
