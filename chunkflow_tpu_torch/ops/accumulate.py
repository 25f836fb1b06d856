"""Bump-weighted overlap-add: the back half of the patch loop.

The counterpart of ``chunkflow_tpu/ops/pallas_blend.py``. One batch of
patch predictions is weighted by the bump map and the patch validity and
added into the chunk's output and weight buffers, in place, in ascending
patch order — the order the JAX package's ``lax.scatter_add`` and its
sequential Pallas grid both apply, and what makes the float32 result
bitwise reproducible.

:func:`fused_accumulate_patches` launches the hand-written CUDA kernel
(``csrc/accumulate.cu``, which replaces the Pallas kernel
``pallas_blend.fused_accumulate_patches``) for CUDA buffers, and runs the
plain PyTorch version :func:`fused_accumulate_patches_plain` for CPU
buffers — dispatch by device only. The TPU kernel's aligned-window buffer
padding (``padded_patch_shape``, ``buffer_padding``) is a Mosaic tiling
rule and has no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from chunkflow_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads it to show
# the main path went through the kernel)
launches = 0


def _check(out, weight, preds, valid, bump, out_starts) -> np.ndarray:
    """Validate the operands; returns the host starts table."""
    for name, t in (("out", out), ("weight", weight), ("preds", preds),
                    ("valid", valid), ("bump", bump)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
    if out.dim() != 4 or weight.shape != out.shape[1:]:
        raise ValueError(f"out [co, z, y, x] / weight [z, y, x] mismatch: "
                         f"{tuple(out.shape)} vs {tuple(weight.shape)}")
    if preds.dim() != 5 or preds.shape[1] != out.shape[0] \
            or preds.shape[2:] != bump.shape:
        raise ValueError(f"preds must be [B, co, *bump.shape] = "
                         f"[B, {out.shape[0]}, {tuple(bump.shape)}], got "
                         f"{tuple(preds.shape)}")
    B = preds.shape[0]
    if valid.shape != (B,):
        raise ValueError(f"valid must be [{B}], got {tuple(valid.shape)}")
    if out_starts.dtype != torch.int32 or out_starts.shape != (B, 3):
        raise TypeError(f"out_starts must be [{B}, 3] int32, got "
                        f"{tuple(out_starts.shape)} {out_starts.dtype}")
    if out_starts.device.type != "cpu":
        raise ValueError("out_starts is the host starts table: pass it on "
                         "the CPU")
    starts = out_starts.numpy()
    pout = np.asarray(bump.shape)
    if B and ((starts < 0).any()
              or (starts + pout > np.asarray(weight.shape)).any()):
        raise ValueError(f"patch windows of size {tuple(bump.shape)} at "
                         f"{starts.tolist()} leave the buffer "
                         f"{tuple(weight.shape)}")
    return starts


def fused_accumulate_patches_plain(out, weight, preds, valid, bump,
                                   out_starts, pre_weighted: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the CUDA kernel: for b ascending,
    ``out[:, s_b : s_b + p] += (preds[b] * bump) * valid[b]`` (``preds[b]``
    as-is when ``pre_weighted``) and ``weight[s_b : s_b + p] += bump *
    valid[b]``, in place, on whatever device the buffers lie."""
    starts = _check(out, weight, preds, valid, bump, out_starts)
    pz, py, px = bump.shape
    for b, (z, y, x) in enumerate(starts.tolist()):
        v = valid[b]
        window = (slice(z, z + pz), slice(y, y + py), slice(x, x + px))
        contrib = preds[b] if pre_weighted else preds[b] * bump * v
        out[(slice(None),) + window] += contrib
        weight[window] += bump * v
    return out, weight


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("accumulate")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.accumulate_patches_launch.argtypes = [p] * 6 + [i] * 15 + [p]
        lib.accumulate_patches_launch.restype = i
        lib.accumulate_max_batch.argtypes = []
        lib.accumulate_max_batch.restype = i
        lib.accumulate_error_string.argtypes = [i]
        lib.accumulate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_accumulate_patches(out, weight, preds, valid, bump, out_starts,
                             pre_weighted: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight, place and add one batch of predictions, in place.

    out:        ``[co, Z, Y, X]`` float32, updated in place
    weight:     ``[Z, Y, X]`` float32, updated in place
    preds:      ``[B, co, pz, py, px]`` float32 RAW engine predictions —
                or, with ``pre_weighted=True``, an already-weighted stack
                added as-is (the weight buffer still gets ``bump*valid``)
    valid:      ``[B]`` float32 validity (0.0 for batch-padding rows)
    bump:       ``[pz, py, px]`` float32
    out_starts: ``[B, 3]`` int32 zyx corners on the CPU (the host table: it
                rides in the launch parameters, and each launch covers the
                union of its windows)

    CUDA buffers launch the kernel (once per ``accumulate_max_batch()``
    rows, in ascending order); CPU buffers run the plain version.
    Returns ``(out, weight)``.
    """
    if out.device.type == "cpu":
        return fused_accumulate_patches_plain(
            out, weight, preds, valid, bump, out_starts, pre_weighted)
    if out.device.type != "cuda":
        raise ValueError(f"accumulate runs on cuda or cpu, not {out.device}")
    starts = _check(out, weight, preds, valid, bump, out_starts)
    out_starts = out_starts.contiguous()
    B, co = preds.shape[:2]
    lib = _library()
    step = lib.accumulate_max_batch()
    pout = np.asarray(bump.shape)
    global launches
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i0 in range(0, B, step):
            rows = slice(i0, i0 + step)
            lo = starts[rows].min(axis=0)
            hi = (starts[rows] + pout).max(axis=0)
            code = lib.accumulate_patches_launch(
                out.data_ptr(), weight.data_ptr(), preds[rows].data_ptr(),
                valid[rows].data_ptr(), bump.data_ptr(),
                out_starts[rows].data_ptr(), len(starts[rows]), co,
                *weight.shape, *bump.shape, *(int(v) for v in lo),
                *(int(v) for v in hi - lo), int(pre_weighted), stream,
            )
            _build.check(lib, "accumulate", code)
            launches += 1
    return out, weight
