"""Patch-grid enumeration: chunk -> static arrays of patch start coords.

A copy of ``chunkflow_tpu/inference/patching.py`` (numpy only): crop
margin (input - output)//2, stride = output size - output overlap, edge
snapping so the last patch ends exactly at the chunk boundary. The
``[N, 3]`` int32 starts tables are what the gather and accumulate
kernels walk.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from chunkflow_tpu_torch.core.cartesian import Cartesian
from chunkflow_tpu_torch.core.contracts import Spec, contract


class PatchGrid(NamedTuple):
    """Static patch geometry for one (chunk shape, patch config) pair."""

    input_starts: np.ndarray   # [N, 3] int32, zyx corner of each input patch
    output_starts: np.ndarray  # [N, 3] int32, zyx corner of each output patch
    crop_margin: Cartesian     # (input - output) // 2 per axis
    input_patch_size: Cartesian
    output_patch_size: Cartesian

    @property
    def num_patches(self) -> int:
        return self.input_starts.shape[0]


def starts_1d(extent: int, patch: int, stride: int) -> List[int]:
    """Start offsets covering [0, extent) with the last patch snapped flush."""
    if patch > extent:
        raise ValueError(f"patch ({patch}) larger than chunk extent ({extent})")
    starts = list(range(0, extent - patch + 1, max(stride, 1)))
    if starts[-1] != extent - patch:
        starts.append(extent - patch)
    return starts


def enumerate_patches(
    chunk_size,
    input_patch_size,
    output_patch_size=None,
    output_patch_overlap=(0, 0, 0),
) -> PatchGrid:
    chunk_size = Cartesian.from_collection(tuple(chunk_size)[-3:])
    input_patch_size = Cartesian.from_collection(input_patch_size)
    if output_patch_size is None:
        output_patch_size = input_patch_size
    output_patch_size = Cartesian.from_collection(output_patch_size)
    overlap = Cartesian.from_collection(output_patch_overlap)

    margin = (input_patch_size - output_patch_size) // 2
    if (margin * 2) != (input_patch_size - output_patch_size):
        raise ValueError(
            f"input-output patch size difference must be even, got "
            f"{input_patch_size} vs {output_patch_size}"
        )
    stride = output_patch_size - overlap
    if not stride.all_positive():
        raise ValueError(
            f"output overlap {overlap} must be smaller than output patch "
            f"size {output_patch_size}"
        )

    axes = [
        starts_1d(chunk_size[i], input_patch_size[i], stride[i])
        for i in range(3)
    ]
    grid = np.stack(
        np.meshgrid(*[np.asarray(a, dtype=np.int32) for a in axes], indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    return PatchGrid(
        input_starts=grid,
        output_starts=grid + np.asarray(margin, dtype=np.int32),
        crop_margin=margin,
        input_patch_size=input_patch_size,
        output_patch_size=output_patch_size,
    )


@contract(
    _result=(
        Spec("n", 3, dtype="int32"),
        Spec("n", 3, dtype="int32"),
        Spec("n", dtype="float32"),
    ),
)
def pad_to_batch(grid: PatchGrid, batch_size: int):
    """Pad the patch list to a batch multiple; returns (in, out, valid).

    Padded entries repeat the first patch with validity 0: they are
    gathered, run and accumulated like any other row, and contribute
    ``x * 0`` (which keeps the signed-zero bits of the JAX package's
    result).
    """
    n = grid.num_patches
    padded = -n % batch_size
    valid = np.ones(n + padded, dtype=np.float32)
    if padded:
        pad_in = np.repeat(grid.input_starts[:1], padded, axis=0)
        pad_out = np.repeat(grid.output_starts[:1], padded, axis=0)
        in_starts = np.concatenate([grid.input_starts, pad_in], axis=0)
        out_starts = np.concatenate([grid.output_starts, pad_out], axis=0)
        valid[n:] = 0.0
    else:
        in_starts, out_starts = grid.input_starts, grid.output_starts
    return in_starts, out_starts, valid
