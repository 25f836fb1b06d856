"""Smoothing filters: the counterpart of ``chunkflow_tpu/ops/filters.py``.

``gaussian_filter_2d`` blurs each z-section. A host payload goes through
scipy, as the JAX package's host leg does (bitwise). A tensor payload
takes the JAX package's device leg in torch where it lies: separable 1D
convolutions over y then x, reflect padding (numpy's "symmetric") of
radius ``int(4 sigma + 0.5)``, the float32 taps normalized to sum 1.
Each output sums its taps in ascending order, one multiply and one add
per tap (no fused multiply-add), so the card leg is bitwise its CPU leg;
XLA's convolution sums in an order of its own, so against the JAX device
leg it holds to a tolerance (``tests/test_torch_segment_ops.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from chunkflow_tpu_torch.chunk.base import Chunk, as_native_dtype


def gaussian_taps(sigma: float) -> np.ndarray:
    """The device leg's float32 taps: radius ``int(4 sigma + 0.5)``."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    kernel = np.exp(-0.5 * (x / sigma) ** 2)
    kernel /= kernel.sum(dtype=np.float32)
    return kernel


def gaussian_filter_2d(chunk: Chunk, sigma: float = 1.0) -> Chunk:
    """Per-z-section 2D gaussian blur (does not mix z sections), in the
    chunk's dtype."""
    if isinstance(chunk.array, torch.Tensor):
        return chunk._with_array(_gaussian_torch(chunk.array, sigma))
    arr = np.asarray(chunk.array)
    sigma_nd = (0.0, 0.0, sigma, sigma) if arr.ndim == 4 else \
        (0.0, sigma, sigma)
    out = ndimage.gaussian_filter(arr.astype(np.float32), sigma=sigma_nd)
    return chunk._with_array(out.astype(arr.dtype))


def _blur_axis(v: torch.Tensor, taps, axis: int) -> torch.Tensor:
    radius = (len(taps) - 1) // 2
    n = v.shape[axis]
    # reflect padding that repeats the edge voxel (numpy "symmetric"),
    # for a radius of any size: index reflection, then a gather
    index = torch.arange(-radius, n + radius, device=v.device)
    period = 2 * n
    index = index % period
    index = torch.where(index >= n, period - 1 - index, index)
    padded = v.index_select(axis, index)
    out = None
    for t, tap in enumerate(taps):
        term = padded.narrow(axis, t, n) * tap
        out = term if out is None else out + term
    return out


def _gaussian_torch(arr: torch.Tensor, sigma: float) -> torch.Tensor:
    taps = [torch.tensor(t, dtype=torch.float32, device=arr.device)
            for t in gaussian_taps(sigma)]
    v = arr.to(torch.float32)
    v = _blur_axis(v, taps, v.ndim - 2)
    v = _blur_axis(v, taps, v.ndim - 1)
    return v.to(arr.dtype)


def median_filter(chunk: Chunk, size: int = 3) -> Chunk:
    """Per-section median through scipy, on the host (a card payload is
    read once)."""
    arr = as_native_dtype(chunk.array)
    out = ndimage.median_filter(
        arr, size=(1, size, size) if arr.ndim == 3 else (1, 1, size, size))
    return chunk._with_array(out)
