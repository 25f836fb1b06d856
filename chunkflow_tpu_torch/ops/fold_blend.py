"""Scatter-free overlap-add by parity class ("fold").

The counterpart of ``chunkflow_tpu/ops/fold_blend.py``. The chunk is
padded at its high faces until the patch grid is uniform
(``(extent - pin) % stride == 0`` on every axis), so every patch start is
a fixed number. Along an axis, patches whose grid index is congruent
modulo ``k = ceil(pout / stride)`` never overlap; each parity class
therefore lays out as one dense block (pad each patch to ``k * stride``,
then interleave), added at a fixed offset. ``prod(k)`` dense adds (8 for
an overlap below half the output patch) replace every per-patch add.

The JAX package computes fold with XLA operations and no Pallas kernel,
so its port is plain PyTorch on whatever device the stack lies:
strided views, ``F.pad``, permute and reshape, and slice ``add_``. The
classes are added in the JAX package's order (``cz``, then ``cy``, then
``cx``) into a zero buffer, so every voxel sums its patches in the same
order and the float32 result is the JAX package's bit for bit. That
order is not scatter's ascending patch order, so fold is compared with
itself, not with the scatter path, bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from chunkflow_tpu_torch.core.contracts import Spec, contract
from chunkflow_tpu_torch.ops.blend import normalize_blend

Triple = Tuple[int, int, int]


def fold_pad_shape(zyx: Triple, pin: Triple, stride: Triple) -> Triple:
    """Smallest per-axis extents >= ``zyx`` (and >= one input patch)
    making the patch grid uniform: ``(extent - pin) % stride == 0``."""
    out = []
    for length, p, s in zip(zyx, pin, stride):
        length = max(length, p)
        out.append(length + (-(length - p) % s))
    return tuple(out)


def fold_grid(zyx: Triple, pin: Triple, stride: Triple) -> Triple:
    """Patches per axis for a uniform (already padded) shape."""
    for length, p, s in zip(zyx, pin, stride):
        if (length - p) % s:
            raise ValueError(
                f"shape {zyx} is not uniform for patch {pin} stride "
                f"{stride}; pad with fold_pad_shape first")
    return tuple((length - p) // s + 1
                 for length, p, s in zip(zyx, pin, stride))


def _class_counts(g: int, k: int) -> list:
    """Patches in each parity class c (0..k-1): indices c, c+k, ... < g."""
    return [len(range(c, g, k)) for c in range(k)]


@contract(
    stack=Spec("n", "co", "pz", "py", "px", dtype="float32"),
    _result=Spec("co", None, None, None),
)
def fold_accumulate(stack: torch.Tensor, grid: Triple, stride: Triple,
                    pout: Triple, offset: Triple,
                    out_zyx: Triple) -> torch.Tensor:
    """Dense parity-class overlap-add.

    stack: ``[N, co, *pout]`` weighted patches in z-major grid order.
    Returns ``[co, *out_zyx]`` (a view of a larger buffer); patch p's
    window starts at ``offset + grid_index(p) * stride``.
    """
    gz, gy, gx = grid
    n, co = stack.shape[0], stack.shape[1]
    if n != gz * gy * gx:
        raise ValueError(f"{n} patches for a {grid} grid")
    k = tuple(max(1, math.ceil(p / s)) for p, s in zip(pout, stride))
    tile = tuple(ki * si for ki, si in zip(k, stride))
    # headroom: a class's dense block may reach past the output extent by
    # up to tile - pout per axis
    buf_zyx = tuple(
        max(out_zyx[i], max(
            offset[i] + c * stride[i]
            + _class_counts(grid[i], k[i])[c] * tile[i]
            for c in range(k[i])))
        for i in range(3))
    stack = stack.reshape((gz, gy, gx, co) + tuple(pout))
    buf = torch.zeros((co,) + buf_zyx, dtype=stack.dtype, device=stack.device)
    # F.pad lists (low, high) pairs from the last dim backwards
    pad = (0, tile[2] - pout[2], 0, tile[1] - pout[1], 0, tile[0] - pout[0])
    for cz in range(k[0]):
        for cy in range(k[1]):
            for cx in range(k[2]):
                sub = stack[cz::k[0], cy::k[1], cx::k[2]]
                mz, my, mx = sub.shape[:3]
                if 0 in (mz, my, mx):
                    continue
                dense = F.pad(sub, pad).permute(3, 0, 4, 1, 5, 2, 6).reshape(
                    co, mz * tile[0], my * tile[1], mx * tile[2])
                z0 = offset[0] + cz * stride[0]
                y0 = offset[1] + cy * stride[1]
                x0 = offset[2] + cx * stride[2]
                buf[:, z0:z0 + dense.shape[1], y0:y0 + dense.shape[2],
                    x0:x0 + dense.shape[3]].add_(dense)
    return buf[:, :out_zyx[0], :out_zyx[1], :out_zyx[2]]


def build_fold_program(
    forward: Callable,
    num_input_channels: int,
    num_output_channels: int,
    input_patch_size: Triple,
    output_patch_size: Triple,
    stride: Triple,
    batch_size: int,
    bump: torch.Tensor,
    zyx: Triple,
    out_dtype: str = "float32",
):
    """``program(chunk) -> [co, *zyx]`` normalized, for a float32 chunk
    ``[ci, *zyx]`` of a uniform shape (:func:`fold_pad_shape`): gather
    every patch by a fixed slice, run the forward batch by batch (the
    last batch padded with zero patches, dropped after), weight by the
    bump, fold the predictions and the weights, normalize."""
    ci = num_input_channels
    pin = tuple(input_patch_size)
    pout = tuple(output_patch_size)
    stride = tuple(stride)
    grid = fold_grid(zyx, pin, stride)
    margin = tuple((i - o) // 2 for i, o in zip(pin, pout))
    starts = [
        (z, y, x)
        for z in range(0, zyx[0] - pin[0] + 1, stride[0])
        for y in range(0, zyx[1] - pin[1] + 1, stride[1])
        for x in range(0, zyx[2] - pin[2] + 1, stride[2])
    ]
    n = len(starts)
    n_pad = -n % batch_size

    def program(chunk: torch.Tensor) -> torch.Tensor:
        if tuple(chunk.shape) != (ci,) + tuple(zyx):
            raise ValueError(f"fold program for {(ci,) + tuple(zyx)} got "
                             f"{tuple(chunk.shape)}")
        patches = torch.stack([
            chunk[:, z:z + pin[0], y:y + pin[1], x:x + pin[2]]
            for z, y, x in starts])
        if n_pad:
            patches = torch.cat([patches, patches.new_zeros(
                (n_pad, ci) + pin)])
        preds = torch.cat([
            forward(patches[i:i + batch_size])
            for i in range(0, n + n_pad, batch_size)])[:n]
        weighted = preds.float() * bump
        out = fold_accumulate(weighted, grid, stride, pout, margin, zyx)
        wstack = bump.expand((n, 1) + pout)
        weight = fold_accumulate(wstack, grid, stride, pout, margin, zyx)[0]
        return normalize_blend(out, weight, out_dtype)

    return program
