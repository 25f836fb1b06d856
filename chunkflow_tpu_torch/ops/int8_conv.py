"""int8 x int8 -> int32 convolution: the integer op of the real int8 leg.

The JAX package's ``CHUNKFLOW_INT8=real`` leg runs every activation-touched
convolution as one XLA op with int8 operands and int32 sums
(``chunkflow_tpu/inference/precision.py:294-298``). No PyTorch call on the
card does that in 3D (cuDNN takes no int8 3D convolution,
``torch.ops.quantized.conv3d`` is a CPU op that requantizes, and
``torch._int_mm`` would need the im2col materialised), so
:func:`conv3d_int8` launches the hand-written kernel
``csrc/conv3d_int8.cu`` for CUDA operands and runs the plain PyTorch
version :func:`conv3d_int8_plain` for CPU operands — dispatch by device
only, no fallback. Both give the exact integer sums: the plain version
convolves in float64 on the integer grid (exact below 2^53; the largest
sum here is 127 * 127 * 6912 < 2^27) and casts to int32.

:func:`matmul_int8` is the integer matrix product of the GEMM upsample
(``MxuConvTranspose``) and of ``F.linear`` under the real leg: on the
card it is the same kernel as a 1x1x1 convolution of one batch row.

The quantize pass before these and the dequant after them stay torch ops
(``inference/precision.py``), as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from chunkflow_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads it to show
# the main path went through the kernel)
launches = 0

IntOr3 = Union[int, Sequence[int]]


def _triple(v: IntOr3, name: str) -> Tuple[int, int, int]:
    t = (int(v),) * 3 if isinstance(v, int) else tuple(int(e) for e in v)
    if len(t) != 3:
        raise ValueError(f"{name} must be an int or 3 ints, got {v!r}")
    return t


def output_shape(x_shape, w_shape, stride: IntOr3 = 1, padding: IntOr3 = 0,
                 dilation: IntOr3 = 1) -> Tuple[int, ...]:
    """``[B, N, Do, Ho, Wo]`` of the convolution of ``x_shape`` ``[B, C,
    D, H, W]`` by ``w_shape`` ``[N, C, kz, ky, kx]`` (``F.conv3d``'s)."""
    st, pd, dl = (_triple(stride, "stride"), _triple(padding, "padding"),
                  _triple(dilation, "dilation"))
    spatial = tuple((n + 2 * p - d * (k - 1) - 1) // s + 1
                    for n, k, s, p, d in zip(x_shape[2:], w_shape[2:], st,
                                             pd, dl))
    return (x_shape[0], w_shape[0]) + spatial


def _check(x: torch.Tensor, w: torch.Tensor, stride, padding, dilation):
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.dim() != 5:
            raise ValueError(f"{name} must be 5-D, got {tuple(t.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, w takes "
                         f"{w.shape[1]}")
    shape = output_shape(x.shape, w.shape, stride, padding, dilation)
    if min(shape) < 1:
        raise ValueError(f"empty output {shape} for x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    if min(_triple(stride, "stride") + _triple(dilation, "dilation")) < 1 \
            or min(_triple(padding, "padding")) < 0:
        raise ValueError("stride and dilation must be >= 1, padding >= 0")
    return shape


def conv3d_int8_plain(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1,
                      padding: IntOr3 = 0, dilation: IntOr3 = 1
                      ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on whatever device the
    operands lie: ``F.conv3d`` in float64 on the integer grid, cast to
    int32."""
    _check(x, w, stride, padding, dilation)
    return F.conv3d(x.double(), w.double(), None, stride, padding,
                    dilation).to(torch.int32)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("conv3d_int8")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_int8_launch.argtypes = [p, p, p] + [i] * 21 + [p]
        lib.conv3d_int8_launch.restype = i
        lib.conv3d_int8_error_string.argtypes = [i]
        lib.conv3d_int8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _channels_last(t: torch.Tensor, channels: int) -> torch.Tensor:
    """``[n, c, d, h, w]`` -> contiguous ``[n, d, h, w, channels]``, the
    channels zero-padded to ``channels`` (a no-op copy when the quantize
    pass already wrote ``t`` channels-last and no padding is due)."""
    cl = t.permute(0, 2, 3, 4, 1)
    if channels != t.shape[1]:
        cl = F.pad(cl, (0, channels - t.shape[1]))
    return cl.contiguous()


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, stride: IntOr3 = 1,
                padding: IntOr3 = 0, dilation: IntOr3 = 1) -> torch.Tensor:
    """Exact int32 sums of the convolution of int8 ``x`` ``[B, C, D, H,
    W]`` by int8 ``w`` ``[N, C, kz, ky, kx]``: ``F.conv3d``'s arguments
    and output ``[B, N, Do, Ho, Wo]`` (symmetric zero padding, one
    group).

    CUDA operands launch the kernel; the input is read channels-last (a
    tensor the quantize pass wrote with ``memory_format=
    torch.channels_last_3d`` is used as it lies), channels padded to a
    multiple of 4 with zeros. CPU operands run the plain version.
    """
    if x.device.type == "cpu":
        return conv3d_int8_plain(x, w, stride, padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_int8 runs on cuda or cpu, not {x.device}")
    shape = _check(x, w, stride, padding, dilation)
    C = -(-x.shape[1] // 4) * 4
    xc = _channels_last(x, C)
    wc = _channels_last(w, C)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    lib = _library()
    B, _, D, H, W = x.shape
    N, _, kz, ky, kx = w.shape
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.conv3d_int8_launch(
            xc.data_ptr(), wc.data_ptr(), out.data_ptr(), B, D, H, W, C, N,
            kz, ky, kx, *shape[2:], *_triple(stride, "stride"),
            *_triple(padding, "padding"), *_triple(dilation, "dilation"),
            stream)
        _build.check(lib, "conv3d_int8", code)
        launches += 1
    return out


def matmul_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 ``a`` ``[M, K]`` and ``b`` ``[K,
    N]``: the kernel as a 1x1x1 convolution of ``M`` positions by ``N``
    filters (one launch) on the card, the plain version on the CPU."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_int8 takes [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    x = a.t()[None, :, None, None, :]   # [1, K, 1, 1, M]
    w = b.t()[:, :, None, None, None]   # [N, K, 1, 1, 1]
    y = conv3d_int8(x, w)               # [1, N, 1, 1, M]
    return y[0, :, 0, 0, :].t()
