"""Affinity map chunk: the counterpart of ``chunkflow_tpu/chunk/affinity_map.py``.

``quantize`` computes where the payload lies: a host payload with numpy,
as the JAX package; a tensor payload in torch, in the same float32 (or
numpy-promoted) arithmetic, so the bits agree. ``from_segmentation``
builds on the host, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType, as_native_dtype
from chunkflow_tpu_torch.core import ufuncs


class AffinityMap(Chunk):

    """3-channel float 4D chunk of zyx boundary affinities."""

    @classmethod
    def from_chunk(cls, chunk: Chunk) -> "AffinityMap":
        # Chunk.__init__ copies all metadata when given a Chunk
        return cls(chunk)

    @classmethod
    def from_segmentation(
        cls,
        seg,
        inside: float = 1.0,
        boundary: float = 0.0,
        **kwargs,
    ) -> "AffinityMap":
        """Ground-truth affinity graph of a segmentation.

        Channel ``c`` at voxel (z, y, x) holds the edge to its neighbor
        one step NEGATIVE along axis ``c``. An edge scores ``inside`` iff
        both endpoints share the same nonzero label, else ``boundary``;
        label 0 is background and never connects. Leading-plane edges (no
        neighbor in range) score ``inside`` (self-edge)."""
        if isinstance(seg, Chunk):
            kwargs.setdefault("voxel_offset", seg.voxel_offset)
            kwargs.setdefault("voxel_size", seg.voxel_size)
            seg = seg.array
        arr = as_native_dtype(seg)
        if arr.ndim != 3:
            raise ValueError(f"need a 3D (z, y, x) segmentation, got "
                             f"{arr.shape}")
        aff = np.full((3,) + arr.shape, np.float32(inside), np.float32)
        for c in range(3):
            sl_a = [slice(None)] * 3
            sl_b = [slice(None)] * 3
            sl_a[c] = slice(1, None)
            sl_b[c] = slice(0, -1)
            a, b = arr[tuple(sl_a)], arr[tuple(sl_b)]
            aff[(c, *sl_a)] = np.where(
                (a == b) & (a != 0), np.float32(inside), np.float32(boundary)
            )
        return cls(aff, **kwargs)

    def __init__(self, array, **kwargs):
        kwargs.setdefault("layer_type", LayerType.AFFINITY_MAP)
        super().__init__(array, **kwargs)
        if self.ndim != 4:
            raise ValueError("affinity maps are 4D (c, z, y, x)")

    def quantize(self, mode: str = "xy") -> Chunk:
        """Compress to a uint8 grayscale thumbnail chunk.

        ``xy``: mean of the y and x affinity channels; ``z``: z channel
        only."""
        if mode not in ("xy", "z"):
            raise ValueError(f"unknown quantize mode {mode!r}")
        arr = self.array
        if isinstance(arr, torch.Tensor):
            if mode == "xy":
                # numpy's mean(axis=0, dtype=float32) of two channels
                pair = arr[1:3].to(torch.float32)
                gray = (pair[0] + pair[1]) / torch.tensor(
                    2.0, dtype=torch.float32, device=arr.device)
            else:
                gray = arr[0]
            if gray.dtype == torch.bfloat16:
                gray = gray * torch.tensor(255.0, dtype=gray.dtype,
                                           device=gray.device)
            else:
                gray = ufuncs.apply(np.multiply, gray, 255.0)
            gray = torch.clamp(gray, 0, 255).to(torch.uint8)
        else:
            arr = np.asarray(arr)
            if mode == "xy":
                gray = arr[1:3].mean(axis=0, dtype=np.float32)
            else:
                gray = arr[0]
            gray = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
        return Chunk(
            gray,
            voxel_offset=self.voxel_offset,
            voxel_size=self.voxel_size,
            layer_type=LayerType.IMAGE,
        )
