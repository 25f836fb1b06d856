"""The pointwise epilogue of an RSUNet convolution in one pass: the bias,
the folded batch norm, the residual or skip add and the ReLU.

Replaces no TPU kernel: the JAX package's RSUNet
(``chunkflow_tpu/models/rsunet.py``) writes these as separate operations
and leaves their fusion to XLA. :func:`conv_epilogue` launches the
hand-written CUDA kernel (``csrc/conv_epilogue.cu``) on a CUDA output and
runs the plain PyTorch version :func:`conv_epilogue_plain`, today's op
sequence, on a CPU (or ``meta``) one: dispatch by device only. The kernel
rounds where the plain sequence rounds, so both give bitwise the same
tensor. Which steps run follows from what the caller passes:

- ``bias`` alone: the embedding;
- ``scale`` and ``shift`` (a folded batch norm, then a ReLU): a block's
  first two convolutions;
- those and ``other`` (added before the ReLU): a block's third, ``other``
  its residual;
- ``other`` without ``scale``: a transposed convolution and its skip.

The parameters are float32 (the model's) and are rounded to the compute
``dtype`` in the pass, as ``.to(dtype)`` rounds them. The output ``y`` is
updated in place, so a tensor the int8 activation mode
(``inference/precision.Int8Mode``) marked when the convolution returned it
stays marked.
"""
from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from chunkflow_tpu_torch import _build
from chunkflow_tpu_torch.core import telemetry

# kernel launches since the last reset (chip_smoke.py reads it to show
# the main path went through the kernel)
launches = 0

_DTYPES = (torch.bfloat16, torch.float32)


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        other: Optional[torch.Tensor] = None,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: the bias
    (rounded to ``dtype``) added to ``y`` in place in ``y``'s dtype; then,
    with ``scale``, ``y * scale + shift`` (each rounded to ``dtype``,
    combined by type promotion, rounding one after the other, as flax's
    folded batch norm); then ``+ other``; then, with ``scale``, the ReLU.
    ``dtype`` defaults to ``y``'s."""
    dt = dtype or y.dtype
    shape = (-1,) + (1,) * (y.dim() - 2)
    y = y.add_(bias.to(dt).to(y.dtype).view(shape))
    if scale is not None:
        y = y * scale.to(dt).view(shape) + shift.to(dt).view(shape)
    if other is not None:
        y = y + other
    if scale is not None:
        y = F.relu(y)
    return y


def dense(y: torch.Tensor, other: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``y`` and ``other`` in one layout the kernel takes, values
    unchanged: ``y`` as it lies when it is contiguous or
    ``channels_last_3d``, else a contiguous copy; ``other`` in ``y``'s
    layout (copied only when it lies otherwise)."""
    if y.is_contiguous():
        fmt = torch.contiguous_format
    elif y.dim() == 5 and y.is_contiguous(
            memory_format=torch.channels_last_3d):
        fmt = torch.channels_last_3d
    else:
        y, fmt = y.contiguous(), torch.contiguous_format
    if other is not None and not other.is_contiguous(memory_format=fmt):
        other = other.contiguous(memory_format=fmt)
    return y, other


def _check(y, bias, scale, shift, other, dt) -> bool:
    """Validate the operands of a launch; returns whether ``y`` lies
    channels-last."""
    if y.dim() != 5:
        raise ValueError(f"y must be [N, C, D, H, W], got {tuple(y.shape)}")
    if y.dtype not in _DTYPES or dt not in _DTYPES:
        raise TypeError(f"y and the compute dtype must be bfloat16 or "
                        f"float32, got {y.dtype} and {dt}")
    if y.dtype != dt and y.dtype != torch.float32:
        # y * scale would promote to float32: not an in-place result
        raise TypeError(f"a {y.dtype} output with {dt} parameters")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    C = y.shape[1]
    for name, p in (("bias", bias), ("scale", scale), ("shift", shift)):
        if p is None:
            continue
        if p.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {p.dtype}")
        if p.shape != (C,) or not p.is_contiguous():
            raise ValueError(f"{name} must be [{C}] contiguous, got "
                             f"{tuple(p.shape)}")
        if p.device != y.device:
            raise ValueError(f"{name} is on {p.device}, y on {y.device}")
    if y.is_contiguous():
        channels_last = False
    elif y.is_contiguous(memory_format=torch.channels_last_3d):
        channels_last = True
    else:
        raise ValueError("y must be contiguous or channels_last_3d")
    if other is not None:
        if other.device != y.device:
            raise ValueError(f"other is on {other.device}, y on {y.device}")
        if other.dtype != y.dtype or other.shape != y.shape:
            raise ValueError(f"other must be {y.dtype} {tuple(y.shape)}, got "
                             f"{other.dtype} {tuple(other.shape)}")
        fmt = (torch.channels_last_3d if channels_last
               else torch.contiguous_format)
        if not other.is_contiguous(memory_format=fmt):
            raise ValueError("other must lie in y's layout")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (y, bias, scale, shift, other)):
        raise RuntimeError("the conv epilogue kernel computes no gradient: "
                           "run the forward under torch.no_grad()")
    return channels_last


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("conv_epilogue")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv_epilogue_launch.argtypes = [p] * 5 + [ll, i, ll, i, i, p]
        lib.conv_epilogue_launch.restype = i
        lib.conv_epilogue_error_string.argtypes = [i]
        lib.conv_epilogue_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  other: Optional[torch.Tensor] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Finish one convolution's output ``y`` in place and return it.

    y:      ``[N, C, D, H, W]`` bfloat16 or float32, the convolution
            without its bias; contiguous or ``channels_last_3d`` on a card
    bias:   ``[C]`` float32
    scale, shift: ``[C]`` float32 each (a folded batch norm, and a ReLU
            after), or neither
    other:  the residual or skip, ``y``'s dtype, shape and layout, or None
    dtype:  the compute dtype the parameters round to (default ``y``'s;
            ``y`` is either of that dtype or float32)

    A CUDA ``y`` launches the kernel once (nothing computes a gradient
    through it); a CPU or ``meta`` one runs :func:`conv_epilogue_plain`.
    Anything else raises, and so does the launcher on more than 2048
    channels or a ``y`` or ``other`` that does not start 16-byte aligned
    (a view into another tensor's storage).
    """
    kind = y.device.type
    if kind in ("cpu", "meta"):
        return conv_epilogue_plain(y, bias, scale, shift, other, dtype)
    if kind != "cuda":
        raise ValueError(f"conv_epilogue runs on cuda or cpu, not "
                         f"{y.device}")
    dt = dtype or y.dtype
    channels_last = _check(y, bias, scale, shift, other, dt)
    n = y.numel()
    if n == 0:
        return y
    lib = _library()
    N, C = y.shape[:2]
    # the elements of one channel lie in runs this long
    inner = 1 if channels_last else n // (N * C)
    index = y.device.index
    guard = (torch.cuda.device(index)
             if index != torch.cuda.current_device() else nullcontext())
    global launches
    with guard:
        code = lib.conv_epilogue_launch(
            y.data_ptr(), None if other is None else other.data_ptr(),
            bias.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), n, C, inner,
            int(y.dtype == torch.bfloat16), int(dt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "conv_epilogue", code)
    launches += 1
    telemetry.inc("conv_epilogue/launches")
    return y
