"""The gather-forward-blend loop and its normalization.

The counterpart of ``chunkflow_tpu/ops/blend.py`` for the single-device
path: :func:`build_local_blend` walks the chunk's patch batches in order —
gather the batch out of the raw chunk (``ops/gather.py``), run the
engine forward, accumulate the bump-weighted predictions into the output
and weight buffers (``ops/accumulate.py``) — where the JAX package runs
the same steps as a ``lax.scan`` inside one program.
:func:`normalize_blend` divides by the accumulated weight.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from chunkflow_tpu_torch.ops import accumulate as _accumulate
from chunkflow_tpu_torch.ops import gather as _gather


def make_accumulate(output_patch_size: Tuple[int, int, int],
                    bump: torch.Tensor):
    """The ONE per-batch accumulation step:
    ``accumulate(out, weight, preds, valid, starts) -> (out, weight)``
    takes RAW engine predictions; the weighting ``(preds * bump) * valid``
    and the weight contribution ``bump * valid`` happen inside the kernel.
    (The pre-weighted flavour, which the serving and mesh replays use, is
    ``fused_accumulate_patches(..., pre_weighted=True)``.)
    """
    if tuple(bump.shape) != tuple(output_patch_size):
        raise ValueError(f"bump {tuple(bump.shape)} does not match the "
                         f"output patch {tuple(output_patch_size)}")

    def accumulate(out, weight, preds, valid, starts):
        return _accumulate.fused_accumulate_patches(
            out, weight, preds, valid, bump, starts, pre_weighted=False)

    return accumulate


def build_local_blend(
    forward: Callable,
    num_input_channels: int,
    num_output_channels: int,
    input_patch_size: Tuple[int, int, int],
    output_patch_size: Tuple[int, int, int],
    batch_size: int,
    bump: torch.Tensor,
):
    """Returns ``local_blend(chunk, in_starts, out_starts, valid)`` ->
    ``(out, weight)``: weighted partial sums over the patches given.

    chunk:      ``[ci, Z, Y, X]`` raw (see ``gather_patches``)
    in_starts:  ``[n, 3]`` int32 on the CPU, ``n`` a batch multiple
    out_starts: ``[n, 3]`` int32 on the CPU
    valid:      ``[n]`` float32 on the chunk's device; padding rows carry
                0 and are gathered, run and accumulated like any other
    """
    ci = num_input_channels
    co = num_output_channels
    pin = tuple(input_patch_size)
    accumulate = make_accumulate(tuple(output_patch_size), bump)

    def local_blend(chunk, in_starts, out_starts, valid):
        if chunk.shape[0] != ci:
            raise ValueError(f"chunk has {chunk.shape[0]} channels, the "
                             f"engine takes {ci}")
        n = in_starts.shape[0]
        if n % batch_size:
            raise ValueError(f"{n} patches is not a multiple of the batch "
                             f"size {batch_size}; pad with pad_to_batch")
        zyx = tuple(chunk.shape[1:])
        out = torch.zeros((co,) + zyx, dtype=torch.float32,
                          device=chunk.device)
        weight = torch.zeros(zyx, dtype=torch.float32, device=chunk.device)
        for i0 in range(0, n, batch_size):
            rows = slice(i0, i0 + batch_size)
            patches = _gather.gather_patches(chunk, in_starts[rows], pin)
            preds = forward(patches).contiguous()
            accumulate(out, weight, preds, valid[rows], out_starts[rows])
        return out, weight

    return local_blend


def normalize_blend(out: torch.Tensor, weight: torch.Tensor,
                    dtype: str = "float32") -> torch.Tensor:
    """Reciprocal weight normalization; zero where nothing was predicted.
    ``dtype`` narrows the result (accumulation stays float32): ``uint8``
    quantizes [0, 1] maps as ``clip * 255`` then a truncating cast, the
    reference's save-time conversion."""
    result = torch.where(
        weight[None] > 0, out / torch.clamp_min(weight[None], 1e-20), 0.0
    )
    if dtype == "uint8":
        return (torch.clamp(result, 0.0, 1.0) * 255.0).to(torch.uint8)
    if dtype == "bfloat16":
        return result.to(torch.bfloat16)
    if dtype == "float32":
        return result
    raise ValueError(f"output dtype must be float32, bfloat16 or uint8, "
                     f"got {dtype!r}")
