"""numpy's elementwise arithmetic on tensors, bit for bit.

The JAX package computes a host chunk's operators with numpy. The port
computes a tensor payload's operators where the tensor lies, in torch,
and must give numpy's answer: numpy's type resolution (NEP 50: a Python
scalar is weak, ``np.result_type`` rules otherwise, asked of the ufunc
itself through ``resolve_dtypes``), every operand cast to the resolved
loop dtype first, and scalars made tensors of that dtype (torch's own
scalar paths may widen them, and ``scalar / tensor`` runs as a
reciprocal and a multiply). The elementwise operations below are
correctly rounded IEEE operations in both libraries, so the bits agree.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from chunkflow_tpu_torch.core.dtypes import numpy_dtype, torch_dtype

#: numpy ufunc -> the torch function computing it in the resolved dtype
TORCH_UFUNCS = {
    np.add: torch.add,
    np.subtract: torch.sub,
    np.multiply: torch.mul,
    np.true_divide: torch.div,
    np.negative: torch.neg,
    np.positive: torch.clone,
    np.absolute: torch.abs,
    np.maximum: torch.maximum,
    np.minimum: torch.minimum,
    np.greater: torch.gt,
    np.greater_equal: torch.ge,
    np.less: torch.lt,
    np.less_equal: torch.le,
    np.equal: torch.eq,
    np.not_equal: torch.ne,
    np.logical_and: torch.logical_and,
    np.logical_or: torch.logical_or,
    np.logical_xor: torch.logical_xor,
    np.logical_not: torch.logical_not,
    np.bitwise_and: torch.bitwise_and,
    np.bitwise_or: torch.bitwise_or,
    np.bitwise_xor: torch.bitwise_xor,
    np.invert: torch.bitwise_not,
}


def _operand_dtype(value):
    """What ``resolve_dtypes`` takes for an operand: a dtype, or the
    Python type of a weak scalar."""
    if isinstance(value, torch.Tensor):
        dt = numpy_dtype(value.dtype)
        if dt is None:
            raise TypeError(f"numpy has no {value.dtype}: no numpy rule "
                            f"decides this operation's dtype")
        return dt
    if isinstance(value, (np.ndarray, np.generic)):
        return value.dtype
    if isinstance(value, bool):
        return np.dtype(np.bool_)
    for kind in (int, float, complex):
        if isinstance(value, kind):
            return kind
    if isinstance(value, numbers.Number):
        return np.asarray(value).dtype
    raise TypeError(f"unsupported operand {type(value).__name__}")


def as_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` (tensor, array or scalar) as a tensor of ``dtype`` on
    ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if isinstance(value, np.ndarray):
        host = np.ascontiguousarray(value)
        if not host.flags.writeable:
            host = host.copy()
        return torch.from_numpy(host).to(device=device, dtype=dtype)
    return torch.tensor(value, dtype=dtype, device=device)


def apply(ufunc, *operands):
    """``ufunc(*operands)`` with numpy's semantics, computed in torch on
    the device of the first tensor operand. Raises ``TypeError`` for a
    ufunc without a bitwise torch counterpart."""
    fn = TORCH_UFUNCS.get(ufunc)
    if fn is None:
        raise TypeError(f"np.{ufunc.__name__} has no bitwise torch "
                        f"counterpart here")
    device = next(o.device for o in operands if isinstance(o, torch.Tensor))
    dtypes = ufunc.resolve_dtypes(
        tuple(_operand_dtype(o) for o in operands) + (None,) * ufunc.nout)
    args = [as_tensor(o, torch_dtype(dt), device)
            for o, dt in zip(operands, dtypes)]
    out = fn(*args)
    want = torch_dtype(dtypes[-1])
    return out if out.dtype == want else out.to(want)

