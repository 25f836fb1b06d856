"""Device-resident patch gather: the front half of the patch loop.

The counterpart of ``chunkflow_tpu/ops/pallas_gather.py``. The chunk is
uploaded once in its RAW dtype (a uint8 EM chunk rides host-to-device at
1/4 the bytes of float32) and every batch of input patches is gathered
out of it by a starts table, with the int -> float32 normalization
applied per element on the way: no full-chunk float32 copy exists.

:func:`gather_patches` launches the hand-written CUDA kernel
(``csrc/gather.cu``, which replaces the Pallas kernel
``pallas_gather.gather_patches``) for a CUDA chunk, and runs the plain
PyTorch version :func:`gather_patches_plain` for a CPU chunk — dispatch
by device only. Both give bitwise the same float32 patches: the
conversion is exact int -> float32 then one IEEE float32 multiply, and
slicing commutes with it. The TPU kernel's aligned-window machinery
(``gather_window``, ``gather_buffer_padding``) is a Mosaic tiling rule
and has no counterpart here.
"""
from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from chunkflow_tpu_torch import _build
from chunkflow_tpu_torch.core.dtypes import numpy_dtype

Triple = Tuple[int, int, int]

# kernel launches since the last reset (chip_smoke.py reads it to show
# the main path went through the kernel)
launches = 0

# the kernel's template instances (csrc/gather.cu gather_patches_launch)
_DTYPE_CODES = {
    torch.uint8: 0,
    torch.int8: 1,
    torch.uint16: 2,
    torch.int16: 3,
    torch.int32: 4,
    torch.uint32: 5,
    torch.float32: 6,
}


def int_scale(dtype) -> Optional[np.float32]:
    """The normalization scale ``float32(1/iinfo.max)`` of an int dtype
    (numpy or torch); None for floats."""
    dt = numpy_dtype(dtype)
    if dt is not None and dt.kind in "iu":
        return np.float32(1.0 / np.iinfo(dt).max)
    return None


def raw_eligible(dtype) -> bool:
    """Whether a chunk (numpy) dtype may ride to the device RAW and be
    converted by the gather: float32 (no conversion) and ints up to 32
    bits. 64-bit ints and other floats convert on the host."""
    dt = np.dtype(dtype)
    return dt == np.float32 or (dt.kind in "iu" and dt.itemsize <= 4)


def convert_chunk(chunk: torch.Tensor) -> torch.Tensor:
    """Raw chunk -> float32, the one normalization every gather applies:
    ints scale to [0, 1] by ``1/iinfo.max`` (exact int -> float32, then
    one float32 multiply); float32 passes through; other floats round to
    nearest."""
    scale = int_scale(chunk.dtype)
    if scale is not None:
        return chunk.to(torch.float32).mul_(float(scale))
    if chunk.dtype == torch.float32:
        return chunk
    return chunk.to(torch.float32)


# each dtype's kernel arguments: its code and its scale (1.0 for float32,
# which the kernel never scales)
_LAUNCH_ARGS = {dtype: (code, float(int_scale(dtype) or 1.0))
                for dtype, code in _DTYPE_CODES.items()}


def _check(chunk: torch.Tensor, in_starts: torch.Tensor,
           input_patch_size: Triple) -> Tuple[int, ...]:
    if chunk.dim() != 4:
        raise ValueError(f"chunk must be [ci, z, y, x], got {tuple(chunk.shape)}")
    if chunk.dtype not in _DTYPE_CODES:
        raise TypeError(f"gather takes {sorted(map(str, _DTYPE_CODES))} "
                        f"chunks, got {chunk.dtype}")
    if not chunk.is_contiguous():
        raise ValueError("chunk must be contiguous")
    if in_starts.dtype != torch.int32 or in_starts.dim() != 2 \
            or in_starts.shape[1] != 3:
        raise TypeError(f"in_starts must be [B, 3] int32, got "
                        f"{tuple(in_starts.shape)} {in_starts.dtype}")
    if in_starts.device.type != "cpu":
        raise ValueError("in_starts is the host starts table: pass it on "
                         "the CPU")
    pin = pz, py, px = tuple(int(p) for p in input_patch_size)
    _, Z, Y, X = chunk.shape
    # plain Python: a few rows check in a fraction of numpy's call overhead
    for z, y, x in in_starts.tolist():
        if min(z, y, x) < 0 or z + pz > Z or y + py > Y or x + px > X:
            raise ValueError(f"patch windows of size {pin} at "
                             f"{in_starts.tolist()} leave the chunk "
                             f"{(Z, Y, X)}")
    return pin


def gather_patches_plain(chunk: torch.Tensor, in_starts: torch.Tensor,
                         input_patch_size: Triple) -> torch.Tensor:
    """``out[b] = convert(chunk[:, s_b : s_b + pin])`` in PyTorch ops —
    the plain version of the CUDA kernel, on whatever device ``chunk``
    lies. chunk ``[ci, Z, Y, X]`` raw; in_starts ``[B, 3]`` int32 on the
    CPU; returns ``[B, ci, pz, py, px]`` float32."""
    pz, py, px = _check(chunk, in_starts, input_patch_size)
    B, ci = in_starts.shape[0], chunk.shape[0]
    out = torch.empty((B, ci, pz, py, px), dtype=torch.float32,
                      device=chunk.device)
    for b, (z, y, x) in enumerate(in_starts.tolist()):
        out[b] = convert_chunk(chunk[:, z:z + pz, y:y + py, x:x + px])
    return out


class _Kernel(NamedTuple):
    lib: ctypes.CDLL
    max_batch: int              # starts rows one launch takes


_kernel: Optional[_Kernel] = None


def _library() -> _Kernel:
    global _kernel
    if _kernel is None:
        lib = _build.load("gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_patches_launch.argtypes = [
            p, i, p, i, p, i, i, i, i, i, i, i, ctypes.c_float, p,
        ]
        lib.gather_patches_launch.restype = i
        lib.gather_max_batch.argtypes, lib.gather_max_batch.restype = [], i
        lib.gather_occupancy.argtypes = [i, ctypes.POINTER(i),
                                         ctypes.POINTER(i)]
        lib.gather_occupancy.restype = i
        lib.gather_error_string.argtypes = [i]
        lib.gather_error_string.restype = ctypes.c_char_p
        _kernel = _Kernel(lib, lib.gather_max_batch())
    return _kernel


def occupancy(dtype: torch.dtype) -> Tuple[int, int]:
    """``(blocks per SM, SMs)`` of the kernel's instance for a chunk dtype
    on the current CUDA device: one launch holds at most their product of
    blocks, all resident at once."""
    kernel = _library()
    per_sm, sms = ctypes.c_int(), ctypes.c_int()
    _build.check(kernel.lib, "gather", kernel.lib.gather_occupancy(
        _DTYPE_CODES[dtype], ctypes.byref(per_sm), ctypes.byref(sms)))
    return per_sm.value, sms.value


def gather_patches(chunk: torch.Tensor, in_starts: torch.Tensor,
                   input_patch_size: Triple) -> torch.Tensor:
    """Gather and convert one batch of patches out of the RAW chunk.

    chunk:     ``[ci, Z, Y, X]`` uint8/int8/uint16/int16/int32/uint32/
               float32, contiguous (a view with a storage offset is fine)
    in_starts: ``[B, 3]`` int32 zyx corners on the CPU (the host table;
               it rides in the kernel's launch parameters)
    returns:   ``[B, ci, pz, py, px]`` float32 on ``chunk``'s device

    A CUDA chunk launches the kernel (once per ``max_batch`` rows of the
    table, in ascending order); a CPU chunk runs the plain version.
    """
    if chunk.device.type == "cpu":
        return gather_patches_plain(chunk, in_starts, input_patch_size)
    if chunk.device.type != "cuda":
        raise ValueError(f"gather runs on cuda or cpu, not {chunk.device}")
    pz, py, px = _check(chunk, in_starts, input_patch_size)
    kernel = _library()
    in_starts = in_starts.contiguous()
    B, ci = in_starts.shape[0], chunk.shape[0]
    out = torch.empty((B, ci, pz, py, px), dtype=torch.float32,
                      device=chunk.device)
    code, scale = _LAUNCH_ARGS[chunk.dtype]
    step = kernel.max_batch
    # sub-launch i0 starts at starts row i0 (12 bytes a row) and at output
    # patch i0
    out_ptr, out_stride = out.data_ptr(), ci * pz * py * px * 4
    starts_ptr = in_starts.data_ptr()
    index = chunk.device.index
    guard = (torch.cuda.device(index)
             if index != torch.cuda.current_device() else nullcontext())
    global launches
    with guard:
        stream = torch.cuda.current_stream().cuda_stream
        for i0 in range(0, B, step):
            status = kernel.lib.gather_patches_launch(
                chunk.data_ptr(), code, starts_ptr + i0 * 12,
                min(step, B - i0), out_ptr + i0 * out_stride, ci,
                *chunk.shape[1:], pz, py, px, scale, stream,
            )
            _build.check(kernel.lib, "gather", status)
            launches += 1
    return out
