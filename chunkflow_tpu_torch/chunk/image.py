"""Grayscale image chunk: the counterpart of ``chunkflow_tpu/chunk/image.py``.

``normalize_contrast`` computes where the payload lies. A host payload
runs the JAX package's host leg (float32 numpy percentiles). A tensor
payload runs in torch on its device and gives the same bits: the order
statistics come from one ``torch.sort`` (``torch.quantile`` refuses
inputs above 2^24 elements, and its interpolation rounds differently),
and the interpolation repeats numpy's ``percentile`` arithmetic step by
step, in float32: the virtual index ``(n - 1) * q`` with ``q`` in the
data's dtype, then ``_lerp``'s two-sided form.
"""
from __future__ import annotations

import numpy as np
import torch

from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
from chunkflow_tpu_torch.core.dtypes import numpy_dtype, torch_dtype


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), dtype=torch.float32,
                        device=device)


def _lerp_indices(n: int, percent: float):
    """numpy's (previous index, next index, gamma, 1 - gamma) of a
    float32 ``percentile(..., percent)`` over ``n`` values (method
    ``linear``; numpy's own scalar arithmetic, so its roundings)."""
    q = np.asanyarray(np.true_divide(percent, np.float32(100)))
    virtual = np.asanyarray((n - 1) * q)
    previous = np.asanyarray(np.floor(virtual))
    following = np.asanyarray(previous + 1)
    if virtual >= n - 1:
        previous, following = np.asanyarray(-1.0), np.asanyarray(-1.0)
    elif virtual < 0:
        previous, following = np.asanyarray(0.0), np.asanyarray(0.0)
    previous = previous.astype(np.intp)
    following = following.astype(np.intp)
    gamma = np.asanyarray(virtual - previous, dtype=virtual.dtype)
    return int(previous), int(following), gamma, 1 - gamma


def percentiles(arr: torch.Tensor, percents, reduce: int):
    """``np.percentile(arr, p, axis=trailing reduce axes, keepdims=True)``
    for each ``p``, bitwise, for a float32 tensor, where it lies."""
    lead = tuple(arr.shape[:-reduce])
    ordered = torch.sort(arr.reshape(lead + (-1,)), dim=-1).values
    n = ordered.shape[-1]
    last = ordered[..., -1]
    out = []
    for percent in percents:
        prev, nxt, gamma, one_minus = _lerp_indices(n, percent)
        a, b = ordered[..., prev], ordered[..., nxt]
        diff = b - a
        if gamma >= 0.5:
            value = b - diff * _f32(one_minus, arr.device)
        else:
            value = a + diff * _f32(gamma, arr.device)
        # a slice holding NaN sorts it last, and numpy returns it
        value = torch.where(torch.isnan(last), last, value)
        out.append(value.reshape(lead + (1,) * reduce))
    return out


class Image(Chunk):
    def __init__(self, array, **kwargs):
        kwargs.setdefault("layer_type", LayerType.IMAGE)
        super().__init__(array, **kwargs)

    @classmethod
    def from_chunk(cls, chunk: Chunk) -> "Image":
        return cls(
            chunk.array,
            voxel_offset=chunk.voxel_offset,
            voxel_size=chunk.voxel_size,
        )

    def inference(self, inferencer) -> Chunk:
        """Run patch-wise convnet inference over this image."""
        return inferencer(self)

    def normalize_shang(
        self,
        nominalmin=None,
        nominalmax=None,
        clipvalues: bool = False,
    ) -> "Image":
        """Slice-wise min/max normalization to a nominal range, Shang's
        method, on the host as the JAX package computes it (a card
        payload is read once)."""
        from chunkflow_tpu_torch.chunk.adjust_grey import normalize_shang
        from chunkflow_tpu_torch.chunk.base import as_native_dtype

        out = normalize_shang(
            as_native_dtype(self.array), nominalmin, nominalmax, clipvalues
        )
        return Image(
            out, voxel_offset=self.voxel_offset, voxel_size=self.voxel_size
        )

    def normalize_contrast(
        self,
        lower_clip_fraction: float = 0.01,
        upper_clip_fraction: float = 0.01,
        minval: int = 1,
        maxval: int = 255,
        per_section: bool = True,
    ) -> "Image":
        """Percentile contrast stretch, per z-section by default: clip the
        darkest/brightest fractions and stretch the remainder to
        [minval, maxval]."""
        lo_q = lower_clip_fraction * 100.0
        hi_q = 100.0 - upper_clip_fraction * 100.0
        kind = numpy_dtype(self.dtype)
        dtype = self.dtype if kind is not None and kind.kind in "iu" \
            else np.uint8
        if isinstance(self.array, torch.Tensor):
            arr = self.array.to(torch.float32)
            dev = arr.device
            lows, highs = percentiles(arr, (lo_q, hi_q),
                                      2 if per_section else 3)
            scale = _f32(maxval - minval, dev) / torch.maximum(
                highs - lows, _f32(1e-6, dev))
            out = (arr - lows) * scale + _f32(minval, dev)
            out = torch.clamp(out, _f32(minval, dev), _f32(maxval, dev))
            out = out.to(torch_dtype(dtype))
        else:
            arr = np.asarray(self.array).astype(np.float32)
            # per z-section (and per channel for 4D): reduce over the
            # trailing (y, x) axes; otherwise over the whole array
            axes = (-2, -1) if per_section else tuple(range(-3, 0))
            lows = np.percentile(arr, lo_q, axis=axes, keepdims=True)
            highs = np.percentile(arr, hi_q, axis=axes, keepdims=True)
            scale = (maxval - minval) / np.maximum(highs - lows, 1e-6)
            out = np.clip((arr - lows) * scale + minval, minval, maxval)
            out = out.astype(dtype)
        return Image(
            out,
            voxel_offset=self.voxel_offset,
            voxel_size=self.voxel_size,
        )
