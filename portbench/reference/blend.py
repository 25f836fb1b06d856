"""Plain chunk inference: patch grid, bump weights, overlap-add, crop.

chunkflow's blend, written out from its definition: patches of the
input size step by ``output - overlap`` and the last one per axis is
moved back to end at the chunk's edge; a uint8 voxel becomes
``float32(v) * float32(1/255)``; each prediction is weighted by the
"wu" bump ``exp(-1/(1-z^2) - 1/(1-y^2) - 1/(1-x^2))`` on the open grid
(-1, 1)^3, computed in float64 and rescaled to [1, 1e6] before the cast
to float32; the weighted predictions and the weights are summed over the
patches, and the output is their quotient where a weight is positive.
A uint8 output is ``trunc(clip(p, 0, 1) * 255)``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def starts_1d(extent: int, patch: int, stride: int) -> List[int]:
    if patch > extent:
        raise ValueError(f"patch {patch} larger than the extent {extent}")
    starts = list(range(0, extent - patch + 1, stride))
    if starts[-1] != extent - patch:
        starts.append(extent - patch)
    return starts


def patch_starts(chunk: Sequence[int], patch: Sequence[int],
                 overlap: Sequence[int]) -> np.ndarray:
    """``[n, 3]`` zyx corners of the patches, z slowest."""
    axes = [starts_1d(c, p, p - o) for c, p, o in zip(chunk, patch, overlap)]
    grid = np.meshgrid(*[np.asarray(a) for a in axes], indexing="ij")
    return np.stack(grid, axis=-1).reshape(-1, 3)


def bump(patch: Sequence[int]) -> np.ndarray:
    coords = [np.linspace(-1.0, 1.0, s + 2)[1:-1] for s in patch]
    zz, yy, xx = np.meshgrid(*coords, indexing="ij")
    with np.errstate(under="ignore"):
        b = np.exp(-1.0 / (1.0 - zz ** 2) - 1.0 / (1.0 - yy ** 2)
                   - 1.0 / (1.0 - xx ** 2))
    b = (b - b.min()) / (b.max() - b.min()) * (1e6 - 1.0) + 1.0
    return b.astype(np.float32)


def infer_chunk(forward: Callable, raw: torch.Tensor, patch: Sequence[int],
                overlap: Sequence[int], out_channels: int,
                batch: int = 4) -> torch.Tensor:
    """``raw`` ``[z, y, x]`` uint8 on a device -> ``[out, z, y, x]``
    float32 on that device. ``forward`` maps ``[B, 1, *patch]`` float32 to
    ``[B, out, *patch]``; patches run ``batch`` at a time."""
    device = raw.device
    shape = tuple(raw.shape)
    starts = patch_starts(shape, patch, overlap)
    weight_map = torch.from_numpy(bump(patch)).to(device)
    scale = torch.tensor(np.float32(1.0 / 255.0), device=device)
    out = torch.zeros((out_channels,) + shape, dtype=torch.float32,
                      device=device)
    weight = torch.zeros(shape, dtype=torch.float32, device=device)

    def window(s):
        return tuple(slice(int(a), int(a) + p) for a, p in zip(s, patch))

    for i in range(0, len(starts), batch):
        rows = starts[i:i + batch]
        x = torch.stack([raw[window(s)] for s in rows])[:, None]
        pred = forward(x.to(torch.float32) * scale)
        for s, p in zip(rows, pred):
            out[(slice(None),) + window(s)] += p * weight_map
            weight[window(s)] += weight_map
    return torch.where(weight[None] > 0,
                       out / torch.clamp_min(weight[None], 1e-20), 0.0)


def to_uint8(prob: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(prob, 0.0, 1.0) * 255.0).to(torch.uint8)
