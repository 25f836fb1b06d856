"""PNG section stacks through Pillow: the counterpart of ``chunkflow_tpu/volume/io_png.py``.

One PNG per z-section, ``<prefix><z:05d>.png`` (reference
flow/save_pngs.py, flow/load_pngs.py). Sections are written at
``compress_level=1``: encoding is zlib-bound and EM noise gains little
from more. A card payload is downloaded once.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
from PIL import Image as PILImage

from chunkflow_tpu_torch.core.bbox import BoundingBox


def save_pngs(chunk, output_path: str, name_prefix: str = "") -> None:
    from chunkflow_tpu_torch.chunk.base import as_native_dtype

    os.makedirs(output_path, exist_ok=True)
    arr = as_native_dtype(chunk.array)
    if arr.ndim == 4:
        if getattr(chunk, "is_affinity_map", False) and arr.shape[0] == 3:
            # reference semantics (save_pngs.py:33-38): the yx-affinity
            # mean as uint8 greyscale. Float affinities are [0,1] and scale
            # by 255; uint8 ones average in a wide type without rescaling.
            if arr.dtype.kind == "f":
                mean = (arr[1] + arr[2]) / 2.0
                arr = (np.clip(mean, 0.0, 1.0) * 255.0).astype(np.uint8)
            elif arr.dtype == np.uint8:
                arr = ((arr[1].astype(np.uint16) + arr[2]) // 2).astype(
                    np.uint8)
            else:
                raise ValueError(
                    f"affinity PNG export supports float or uint8 "
                    f"channels, got {arr.dtype}")
        elif arr.shape[0] != 1:
            raise ValueError("PNG export needs a single-channel chunk")
        else:
            arr = arr[0]
    if arr.dtype.kind == "f":
        # PNG has no float mode: [0,1] sections export as greyscale; other
        # ranges fail rather than saturate
        lo, hi = float(arr.min()), float(arr.max())
        if lo < -1e-3 or hi > 1.0 + 1e-3:
            raise ValueError(
                f"float PNG export expects [0,1] data, got [{lo:.3g}, "
                f"{hi:.3g}]; rescale (e.g. normalize-intensity) or cast "
                "to uint8 first")
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    z0 = chunk.voxel_offset.z
    for i, section in enumerate(arr):
        PILImage.fromarray(section).save(
            os.path.join(output_path, f"{name_prefix}{z0 + i:05d}.png"),
            compress_level=1)


def load_pngs(path: str, bbox: Optional[BoundingBox] = None,
              voxel_offset=(0, 0, 0), dtype=None):
    """A directory of z-section PNGs (ordered by the last number in each
    name) as a chunk at ``voxel_offset``, cut to ``bbox`` if given."""
    from chunkflow_tpu_torch.chunk.base import Chunk

    def section_index(name: str) -> int:
        nums = re.findall(r"\d+", name)
        return int(nums[-1]) if nums else 0

    files = sorted((f for f in os.listdir(path) if f.lower().endswith(".png")),
                   key=section_index)
    if not files:
        raise FileNotFoundError(f"no .png files in {path}")
    sections = []
    for name in files:
        with PILImage.open(os.path.join(path, name)) as img:
            sections.append(np.asarray(img))
    arr = np.stack(sections, axis=0)
    if dtype is not None:
        arr = arr.astype(dtype)
    chunk = Chunk(arr, voxel_offset=voxel_offset)
    if bbox is not None:
        chunk = chunk.cutout(bbox)
    return chunk
