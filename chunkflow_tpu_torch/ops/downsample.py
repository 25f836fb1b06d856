"""Downsampling pyramids: the counterpart of ``chunkflow_tpu/ops/downsample.py``.

Two pooling modes, as the reference's tinybrain use
(flow/downsample_upload.py:73-79):

- images and probability maps: average pooling. The JAX package sums
  each window with ``lax.reduce_window`` in float32, divides by the
  window's size and rounds half to even for integer dtypes. The port
  sums the window's voxels in z-major order, one add each: bitwise on
  integers (exact sums), and on float32 the order XLA's CPU reduce_window
  takes where it does not vectorize (where it does, it adds in pairs: 1
  ulp apart, ``tests/test_torch_segment_ops.py``);
- segmentations: mode pooling, the most frequent label of each window
  by all-pairs equality counts in int8, the first corner in z-major
  order winning ties.

Each computes where its chunk lies: a tensor payload in torch on its
device, a host payload in torch on the CPU (the JAX package runs both in
``jnp``) and back to numpy. 64-bit labels, which the JAX package pools
with numpy for want of x64, go through the same torch leg: it pools them
through their signed view, bitwise the numpy leg (``mode_pool_numpy``,
kept as that leg's plain reference).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, _as_tensor
from chunkflow_tpu_torch.core.cartesian import Cartesian, to_cartesian
from chunkflow_tpu_torch.core.dtypes import signed_view, torch_dtype


def _payload(chunk: Chunk):
    """(the payload as a 4D tensor where it lies, whether it was a host
    array, whether it was 3D)."""
    arr = chunk.array
    on_host = not isinstance(arr, torch.Tensor)
    if on_host:
        arr = _as_tensor(np.asarray(arr))
    squeeze = arr.ndim == 3
    return (arr[None] if squeeze else arr), on_host, squeeze


def _trimmed(arr, factor: Cartesian):
    """A 4D payload (tensor or array) cut to whole pooling windows (a
    VALID window)."""
    z, y, x = (s // f * f for s, f in zip(arr.shape[1:], factor))
    return arr[:, :z, :y, :x]


def _result(chunk: Chunk, pooled, on_host: bool, squeeze: bool,
            factor: Cartesian) -> Chunk:
    """The pooled payload as a chunk at the coarser voxel grid; a tensor
    computed for a host payload goes back to numpy."""
    if squeeze:
        pooled = pooled[0]
    if on_host:
        pooled = pooled.numpy()
    return Chunk(pooled, voxel_offset=chunk.voxel_offset // factor,
                 voxel_size=chunk.voxel_size * factor,
                 layer_type=chunk.layer_type)


def downsample_average(chunk: Chunk, factor=(1, 2, 2)) -> Chunk:
    """Mean of each window, in float32; integer dtypes rounded half to
    even."""
    factor = to_cartesian(factor)
    arr, on_host, squeeze = _payload(chunk)
    arr = _trimmed(arr, factor).to(torch.float32)
    pooled = None
    for dz in range(factor.z):
        for dy in range(factor.y):
            for dx in range(factor.x):
                corner = arr[:, dz::factor.z, dy::factor.y, dx::factor.x]
                pooled = corner.clone() if pooled is None else pooled + corner
    # a 0-d tensor on the payload's device: CUDA divides a tensor by a
    # Python scalar as a multiply by its reciprocal, not correctly rounded
    pooled = pooled / torch.tensor(float(factor.prod()),
                                   device=pooled.device)
    out_dtype = torch_dtype(chunk.dtype)
    if not out_dtype.is_floating_point:
        pooled = torch.round(pooled)
    return _result(chunk, pooled.to(out_dtype), on_host, squeeze, factor)


def _stack_corners_numpy(arr: np.ndarray, factor) -> np.ndarray:
    """[n_corners, c, z', y', x'] corner samples of each pooling block."""
    corners = []
    for dz in range(factor.z):
        for dy in range(factor.y):
            for dx in range(factor.x):
                corners.append(
                    arr[:, dz::factor.z, dy::factor.y, dx::factor.x])
    return np.stack(corners, axis=0)


def mode_pool_numpy(arr: np.ndarray, factor) -> np.ndarray:
    """The JAX package's host mode pool of a 4D array already cut to whole
    windows: exact mode, ties to the first corner (z-major corner order).
    The plain reference that ``mode_pool_device`` is held against."""
    stacked = _stack_corners_numpy(arr, factor)
    n = stacked.shape[0]
    counts = np.zeros(stacked.shape, dtype=np.int8)
    for i in range(n):
        for j in range(n):
            counts[i] += stacked[i] == stacked[j]
    winner = np.argmax(counts, axis=0)
    return np.take_along_axis(stacked, winner[None], axis=0)[0]


def mode_pool_device(arr: torch.Tensor, factor) -> torch.Tensor:
    """The same mode pool in torch where ``arr`` lies: all-pairs equality
    counts in int8, ``argmax`` taking the first corner of the largest
    count. Wide unsigned labels ride as their same-width signed view
    (equality and gathers see the same bits)."""
    view = signed_view(arr)
    c = view.shape[0]
    zp, yp, xp = (view.shape[1] // factor.z, view.shape[2] // factor.y,
                  view.shape[3] // factor.x)
    # czyx -> block axes (c, z', fz, y', fy, x', fx), then the corners
    # first in z-major order (dz, dy, dx)
    blocks = view.reshape(c, zp, factor.z, yp, factor.y, xp, factor.x)
    stacked = blocks.permute(2, 4, 6, 0, 1, 3, 5).reshape(
        factor.z * factor.y * factor.x, c, zp, yp, xp)
    counts = torch.zeros(stacked.shape, dtype=torch.int8,
                         device=stacked.device)
    for j in range(stacked.shape[0]):
        counts += (stacked == stacked[j][None]).to(torch.int8)
    winner = torch.argmax(counts, dim=0, keepdim=True)
    return torch.gather(stacked, 0, winner)[0].view(arr.dtype)


def downsample_mode(chunk: Chunk, factor=(1, 2, 2)) -> Chunk:
    """Mode (most frequent label) pooling for segmentations; ties go to
    the first corner in z-major order, in every leg."""
    factor = to_cartesian(factor)
    arr, on_host, squeeze = _payload(chunk)
    pooled = mode_pool_device(_trimmed(arr, factor), factor)
    return _result(chunk, pooled, on_host, squeeze, factor)


def downsample(chunk: Chunk, factor=(1, 2, 2)) -> Chunk:
    if chunk.is_segmentation:
        return downsample_mode(chunk, factor)
    return downsample_average(chunk, factor)


def pyramid(chunk: Chunk, factor=(1, 2, 2), num_mips: int = 3) -> List[Chunk]:
    """Successive downsamples: [mip+1, mip+2, ...]."""
    levels = []
    current = chunk
    for _ in range(num_mips):
        current = downsample(current, factor)
        levels.append(current)
    return levels
