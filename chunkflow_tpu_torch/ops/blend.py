"""The gather-forward-blend loop and its normalization.

The counterpart of ``chunkflow_tpu/ops/blend.py`` for the single-device
path: :func:`build_local_blend` walks the chunk's patch batches in order —
gather the batch out of the raw chunk (``ops/gather.py``), run the
engine forward, accumulate the bump-weighted predictions into the output
and weight buffers (``ops/accumulate.py``) — where the JAX package runs
the same steps as a ``lax.scan`` inside one program.
:func:`normalize_blend` divides by the accumulated weight. Both carry the
JAX entry points' shape contracts (``core/contracts.py``), and
:func:`pipeline_kernel_cost` is the JAX function's analytic cost of one
patch step, for the program cost ledger. :func:`fold_forward_device`
reads the forwards' device time once a chunk has finished on the card.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from chunkflow_tpu_torch.core import envmode, telemetry
from chunkflow_tpu_torch.core.contracts import Spec, contract
from chunkflow_tpu_torch.core.profiling import EventPairs
from chunkflow_tpu_torch.ops import accumulate as _accumulate
from chunkflow_tpu_torch.ops import gather as _gather


def stack_budget_bytes() -> int:
    """Byte budget for patch stacks kept alive at once, the memory gate of
    the fold path (``CHUNKFLOW_BLEND_STACK_MAX_GB``, default 4 GiB, as in
    the JAX package, so one configuration takes the same path in both):
    a 64x512x512 chunk's fold (~2.4 GiB with its accumulation buffers)
    fits, a 108x2048x2048 task falls back to the per-batch scatter
    path."""
    return int(
        float(os.environ.get("CHUNKFLOW_BLEND_STACK_MAX_GB", "4")) * 2**30)


_REPLAY_CHOICES = {
    "sharded": ("", "1", "on", "sharded", "slab"),
    "replicated": ("0", "off", "replicated", "full"),
}
_REPLAY_WARNED: set = set()


def shard_replay_mode() -> str:
    """``sharded`` or ``replicated``: how the mesh engine
    (``parallel/engine.py``) replays the blend accumulation,
    ``CHUNKFLOW_SHARD_REPLAY`` as the JAX package reads it. ``sharded``
    (the default) replays on each shard only the windows that touch its
    output slab, into a slab+margin buffer; ``replicated`` replays every
    window on every shard into a full-chunk buffer. An unknown value
    prints one note and runs the default. Re-read per chunk."""
    return envmode.resolve(
        "CHUNKFLOW_SHARD_REPLAY", _REPLAY_CHOICES, "sharded",
        "running the sharded (slab) replay default — a typo must not "
        "silently select the full-chunk replicated replay",
        _REPLAY_WARNED)


def device_valid(valid: np.ndarray, device) -> torch.Tensor:
    """A validity column of ones, then zeros (``pad_to_batch``'s, and every
    mesh shard's and replay plan's) built on ``device``, not copied there:
    a copy from pageable memory would wait for the device."""
    n = int(np.count_nonzero(valid))
    if not (valid[:n] == 1).all():
        raise ValueError("a validity column is ones, then zeros")
    out = torch.ones(len(valid), dtype=torch.float32, device=device)
    if n < len(valid):
        out[n:] = 0.0
    return out


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


def fold_forward_device(out) -> None:
    """Fold the forward event pairs that ``Inferencer.infer_async``
    attached to a dispatched output (``_forward_pairs``: the pool and the
    chunk's pairs) into the histogram ``inference/forward_device``
    (seconds per chunk). Called once the output's compute-done event has
    fired, when every pair has finished: nothing waits, and a pair that
    has not finished drops the chunk's sample."""
    timed = getattr(out, "_forward_pairs", None)
    if not timed or not timed[1]:
        return
    pool, pairs = timed
    out._forward_pairs = None
    seconds = [pool.read(pair) for pair in pairs]
    if None not in seconds:
        telemetry.observe("inference/forward_device", sum(seconds))


def build_local_blend(
    forward: Callable,
    num_input_channels: int,
    num_output_channels: int,
    input_patch_size: Tuple[int, int, int],
    output_patch_size: Tuple[int, int, int],
    batch_size: int,
    bump: torch.Tensor,
    events: Optional[EventPairs] = None,
):
    """Returns ``local_blend(chunk, in_starts, out_starts, valid,
    timed=None)`` -> ``(out, weight)``: weighted partial sums over the
    patches given.

    chunk:      ``[ci, Z, Y, X]`` raw (see ``gather_patches``)
    in_starts:  ``[n, 3]`` int32 on the CPU, ``n`` a batch multiple
    out_starts: ``[n, 3]`` int32 on the CPU
    valid:      ``[n]`` float32 on the chunk's device; padding rows carry
                0 and are gathered, run and accumulated like any other
    timed:      a list that gets each batch's forward bracketed by a pair
                of timing events from ``events``, recorded on the current
                stream (for :func:`fold_forward_device`)
    """
    ci = num_input_channels
    co = num_output_channels
    pin = tuple(input_patch_size)
    accumulate = make_accumulate(tuple(output_patch_size), bump)

    @contract(
        chunk=Spec(None, "z", "y", "x"),
        in_starts=Spec("n", 3, dtype="int32"),
        out_starts=Spec("n", 3, dtype="int32"),
        valid=Spec("n", dtype="float32"),
    )
    def local_blend(chunk, in_starts, out_starts, valid, timed=None):
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
            if timed is None:
                preds = forward(patches).contiguous()
            else:
                start, end = events.take()
                start.record()
                preds = forward(patches).contiguous()
                end.record()
                timed.append((start, end))
            accumulate(out, weight, preds, valid[rows], out_starts[rows])
        return out, weight

    return local_blend


def pipeline_kernel_cost(B: int, ci: int, co: int, pin, pout,
                         dtype="uint8", covered=None) -> dict:
    """Analytic cost of one patch step over a batch of ``B`` patches: the
    gather's and the accumulate's (``ops/gather.gather_kernel_cost``,
    ``ops/accumulate.fused_kernel_cost``) summed, as the JAX
    ``pipeline_kernel_cost`` composes them; its ``flops`` equal the JAX
    function's. ``hbm_intermediate_bytes`` is the JAX formula: the
    gathered float32 patch stack and the float32 prediction stack, each
    written by one step and read by the next (x2 per stack); the port
    materializes both. ``vmem_bytes`` is None (no VMEM on the card)."""
    pin = tuple(pin)
    pout = tuple(pout)
    g = _gather.gather_kernel_cost(B, ci, pin, dtype)
    a = _accumulate.fused_kernel_cost(B, co, pout, covered)
    patch_stack_f32 = B * ci * int(np.prod(pin)) * 4
    pred_stack_f32 = B * co * int(np.prod(pout)) * 4
    return {
        "flops": g["flops"] + a["flops"],
        "bytes_accessed": g["bytes_accessed"] + a["bytes_accessed"],
        "vmem_bytes": None,
        "hbm_intermediate_bytes": 2 * (patch_stack_f32 + pred_stack_f32),
    }


@contract(
    out=Spec("co", "z", "y", "x", dtype="float32"),
    weight=Spec("z", "y", "x", dtype="float32"),
)
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
