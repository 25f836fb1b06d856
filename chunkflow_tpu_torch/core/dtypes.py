"""numpy <-> torch dtype mapping for chunk payloads.

A chunk payload is a numpy array or a ``torch.Tensor``; the inference
front decides what to convert on the host and what rides to the device
raw by the payload's numpy dtype, whichever container holds it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_TORCH_TO_NUMPY = {
    torch.bool: np.dtype(np.bool_),
    torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8),
    torch.uint16: np.dtype(np.uint16),
    torch.int16: np.dtype(np.int16),
    torch.uint32: np.dtype(np.uint32),
    torch.int32: np.dtype(np.int32),
    torch.uint64: np.dtype(np.uint64),
    torch.int64: np.dtype(np.int64),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}

# torch implements many ops (index_select, any, ...) for the unsigned
# types wider than a byte only on some devices; a same-width signed view
# carries the same bits through them
_SIGNED_VIEW = {
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}


def numpy_dtype(dtype) -> Optional[np.dtype]:
    """The numpy dtype of a numpy or torch dtype; None for torch dtypes
    numpy lacks (bfloat16)."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NUMPY.get(dtype)
    return np.dtype(dtype)


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` reinterpreted as the same-width signed int where it is a wide
    unsigned int, else ``t`` itself (see ``_SIGNED_VIEW``)."""
    signed = _SIGNED_VIEW.get(t.dtype)
    return t if signed is None else t.view(signed)
