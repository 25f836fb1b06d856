"""The yardstick's arithmetic: peaks of the card, the convolutions'
operations and the hand-written kernels' bytes, all from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W): 989
TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35
TB/s of HBM.

The kernels' bounds count each input byte read once and each output byte
written once:

- gather, one launch of ``B`` rows: each patch element read once in the
  chunk's dtype and written once as float32, the ``[B, 3]`` int32 starts
  read once; one multiply per element;
- accumulate, one launch of ``B`` rows: the float32 predictions, the bump
  map, the validity and the starts read once, every output and weight
  cell the batch's windows cover read and written once; per patch voxel
  two multiplies and an add per channel, then a multiply and an add for
  the weight.

A launch takes at most 64 rows (the kernels' ``kMaxBatch``), so a batch
of the configurations here is one launch of each kernel.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import blend, models

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
MAX_LAUNCH_ROWS = 64


class _Counter(models.Ops):
    def __init__(self, dtype):
        super().__init__(dtype)
        self.flops = 0

    def conv(self, x, w, b):
        y = super().conv(x, w, b)
        self.flops += 2 * y.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
        return y

    def conv_t(self, x, w, b, stride):
        self.flops += 2 * x.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
        return super().conv_t(x, w, b, stride)


def conv_flops(config: dict, patch: Sequence[int]) -> int:
    """Multiply-adds (x2) of the convolutions in one patch's forward."""
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _ in models.param_spec(config)}
    counter = _Counter(torch.float32)
    x = torch.empty((1, config["in_channels"]) + tuple(patch), device="meta")
    models.forward(config, params, x, counter)
    return counter.flops


def _padded(starts: np.ndarray, batch: int) -> np.ndarray:
    pad = -len(starts) % batch
    return np.concatenate([starts, np.repeat(starts[:1], pad, 0)]) \
        if pad else starts


def _covered(starts: np.ndarray, patch: Sequence[int]) -> int:
    lo = starts.min(0)
    hi = starts.max(0) + np.asarray(patch)
    mask = np.zeros(tuple(hi - lo), dtype=bool)
    for s in starts - lo:
        mask[tuple(slice(a, a + p) for a, p in zip(s, patch))] = True
    return int(mask.sum())


def chunk_costs(chunk: Sequence[int], patch: Sequence[int],
                overlap: Sequence[int], batch: int, in_channels: int,
                out_channels: int, in_itemsize: int = 1) -> Dict[str, dict]:
    """Per kernel, over one chunk: ``launches``, ``bytes`` and ``ops`` (the
    sums over its launches) and ``bound_s`` (the sum of each launch's
    least time on the card)."""
    starts = _padded(blend.patch_starts(chunk, patch, overlap), batch)
    voxels = int(np.prod(patch))
    costs = {k: {"launches": 0, "bytes": 0, "ops": 0, "bound_s": 0.0}
             for k in ("gather", "accumulate")}
    for i in range(0, len(starts), batch):
        for j in range(i, min(i + batch, len(starts)), MAX_LAUNCH_ROWS):
            rows = starts[j:min(j + MAX_LAUNCH_ROWS, i + batch)]
            b = len(rows)
            work = {
                "gather": (b * in_channels * voxels * (in_itemsize + 4)
                           + b * 12,
                           b * in_channels * voxels),
                "accumulate": ((b * out_channels * voxels + voxels + b) * 4
                               + b * 12
                               + 2 * (out_channels + 1) * 4
                               * _covered(rows, patch),
                               b * voxels * (3 * out_channels + 2)),
            }
            for name, (nbytes, ops) in work.items():
                c = costs[name]
                c["launches"] += 1
                c["bytes"] += nbytes
                c["ops"] += ops
                c["bound_s"] += max(nbytes / PEAK_HBM_BYTES,
                                    ops / PEAK_F32_FLOPS)
    return costs


def patches_per_chunk(chunk: Sequence[int], patch: Sequence[int],
                      overlap: Sequence[int]) -> int:
    """The patches a chunk needs, filler rows not counted."""
    return len(blend.patch_starts(chunk, patch, overlap))
