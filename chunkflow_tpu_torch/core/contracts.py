"""Lightweight runtime shape/dtype contracts for chunk-geometry APIs.

The counterpart of ``chunkflow_tpu/core/contracts.py``, with its names,
its semantics and its error texts. The blending stack's correctness
hinges on array-shape conventions (czyx channel-leading chunks, ``[N, 3]``
zyx start tables, float32 accumulators) that Python cannot express in
signatures. ``@contract`` declares them at the public entry points and
validates every call:

    @contract(out=Spec("co", "z", "y", "x", dtype="float32"),
              weight=Spec("z", "y", "x", dtype="float32"))
    def normalize_blend(out, weight, dtype="float32"): ...

Dimension entries are exact ints, named symbols (equal names must match
across all specs in one call: ``"z"`` above ties ``out`` and ``weight``
to the same grid), or None for don't-care; a leading or trailing ``...``
allows extra dims.

Validation reads ONLY ``.shape``, ``.ndim`` and ``.dtype``: on a CUDA
tensor none of them waits for the device. Dtypes compare by their numpy
names (``"float32"``, ``"int32"``, ``"uint8"``, ``"bfloat16"``), whether
the value is a torch tensor, a numpy array or a ``Chunk``: a
``torch.dtype`` has no ``.name`` and prints as ``torch.float32``, so it
is named by the part after the dot.

:func:`check_abstract` is the counterpart of ``jax.eval_shape``: it runs
a function on ``meta`` tensors of the given shapes and dtypes (no FLOP,
no card) and returns the abstract result, so a contract, the result's
included, is checked without running a kernel. The port's kernel wrappers
dispatch by device; a ``meta`` tensor takes their plain path, which on
``meta`` computes shapes only.

``CHUNKFLOW_CONTRACTS=0`` (or ``off``, ``false``) strips every check; it
is read on every call.
"""
from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Dict, Optional, Tuple

__all__ = ["ContractError", "contracts_enabled", "Spec", "contract",
           "check_abstract", "dtype_name"]


class ContractError(TypeError):
    """An argument or result violated a declared shape/dtype contract."""


def contracts_enabled() -> bool:
    return os.environ.get("CHUNKFLOW_CONTRACTS", "1").lower() not in (
        "0", "off", "false",
    )


def dtype_name(dt) -> str:
    """The numpy name of a dtype: numpy dtypes by ``.name``, torch dtypes
    by ``str`` without the ``torch.`` prefix (``torch.float32`` ->
    ``"float32"``)."""
    name = getattr(dt, "name", None)
    if isinstance(name, str):
        return name
    text = str(dt)
    return text[len("torch."):] if text.startswith("torch.") else text


class Spec:
    """Shape/dtype expectation for one array-like value.

    ``Spec("co", "z", "y", "x")``: 4D with dims named for cross-argument
    consistency. ``Spec(ndim=4)``: rank only. ``Spec(..., 3)``: any dims
    then a final extent-3 axis. ``dtype=`` accepts one name or a tuple of
    admissible names.
    """

    def __init__(self, *dims, ndim=None, dtype=None, optional=False):
        self.dims: Optional[Tuple] = tuple(dims) if dims else None
        if self.dims is not None and self.dims.count(Ellipsis) > 1:
            raise ValueError("at most one ... per Spec")
        self.ndim = ndim
        self.dtypes: Optional[Tuple[str, ...]] = (
            (dtype,) if isinstance(dtype, str) else tuple(dtype)
        ) if dtype is not None else None
        self.optional = optional

    def __repr__(self):
        parts = []
        if self.dims is not None:
            parts.append(
                "(" + ", ".join(
                    "..." if d is Ellipsis else repr(d) for d in self.dims
                ) + ")"
            )
        if self.ndim is not None:
            parts.append(f"ndim={self.ndim}")
        if self.dtypes is not None:
            parts.append(f"dtype={'|'.join(self.dtypes)}")
        return f"Spec({', '.join(parts)})"

    # ------------------------------------------------------------------
    def validate(self, value: Any, where: str,
                 bindings: Dict[str, int]) -> None:
        if value is None:
            if self.optional:
                return
            raise ContractError(f"{where}: required value is None")
        shape = getattr(value, "shape", None)
        if shape is None:
            raise ContractError(
                f"{where}: expected an array-like with .shape, got "
                f"{type(value).__name__}"
            )
        shape = tuple(shape)
        if self.ndim is not None:
            allowed = (
                self.ndim if isinstance(self.ndim, tuple) else (self.ndim,)
            )
            if len(shape) not in allowed:
                raise ContractError(
                    f"{where}: rank {len(shape)} (shape {shape}), "
                    f"contract wants ndim {self.ndim}"
                )
        if self.dims is not None:
            self._match_dims(shape, where, bindings)
        if self.dtypes is not None:
            name = dtype_name(getattr(value, "dtype", None))
            if name not in self.dtypes:
                raise ContractError(
                    f"{where}: dtype {name}, contract wants "
                    f"{' or '.join(self.dtypes)}"
                )

    def _match_dims(self, shape: Tuple[int, ...], where: str,
                    bindings: Dict[str, int]) -> None:
        dims = self.dims
        if Ellipsis in dims:
            i = dims.index(Ellipsis)
            head, tail = dims[:i], dims[i + 1:]
            if len(shape) < len(head) + len(tail):
                raise ContractError(
                    f"{where}: shape {shape} too short for contract "
                    f"{self!r}"
                )
            pairs = list(zip(head, shape[:len(head)]))
            if tail:
                pairs += list(zip(tail, shape[-len(tail):]))
        else:
            if len(shape) != len(dims):
                raise ContractError(
                    f"{where}: shape {shape} has rank {len(shape)}, "
                    f"contract {self!r} wants {len(dims)}"
                )
            pairs = list(zip(dims, shape))
        for dim, actual in pairs:
            if dim is None:
                continue
            if isinstance(dim, int):
                if actual != dim:
                    raise ContractError(
                        f"{where}: shape {shape} violates contract "
                        f"{self!r} (expected extent {dim}, got {actual})"
                    )
            else:  # named symbol: must be consistent across the call
                prev = bindings.setdefault(str(dim), actual)
                if prev != actual:
                    raise ContractError(
                        f"{where}: dim '{dim}'={actual} conflicts with "
                        f"'{dim}'={prev} bound earlier in this call"
                    )


def contract(_result=None, **arg_specs):
    """Declare per-argument (by name) and result shape contracts.

    ``_result`` is a Spec, or a tuple of Specs for tuple-returning
    functions. Unknown argument names fail at decoration time, so a
    contract can't silently drift off its signature.
    """
    for spec in list(arg_specs.values()) + (
        list(_result) if isinstance(_result, tuple) else
        [_result] if _result is not None else []
    ):
        if not isinstance(spec, Spec):
            raise TypeError(f"contract specs must be Spec, got {spec!r}")

    def decorate(fn):
        sig = inspect.signature(fn)
        unknown = set(arg_specs) - set(sig.parameters)
        if unknown:
            raise TypeError(
                f"@contract on {fn.__qualname__}: no such parameter(s) "
                f"{sorted(unknown)}"
            )

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not contracts_enabled():
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bindings: Dict[str, int] = {}
            for name, spec in arg_specs.items():
                if name in bound.arguments:
                    spec.validate(
                        bound.arguments[name],
                        f"{fn.__qualname__}(..{name}..)", bindings,
                    )
            result = fn(*args, **kwargs)
            if _result is not None:
                _validate_result(fn.__qualname__, _result, result, bindings)
            return result

        wrapper.__contract__ = {"args": dict(arg_specs), "result": _result}
        return wrapper

    return decorate


def _validate_result(qualname, result_spec, result, bindings):
    if isinstance(result_spec, tuple):
        if not isinstance(result, tuple) or len(result) != len(result_spec):
            raise ContractError(
                f"{qualname}: result contract wants a {len(result_spec)}-"
                f"tuple, got {type(result).__name__}"
            )
        for i, (spec, value) in enumerate(zip(result_spec, result)):
            spec.validate(value, f"{qualname} -> result[{i}]", bindings)
    else:
        result_spec.validate(result, f"{qualname} -> result", bindings)


def _abstract(value):
    """A ``meta`` tensor of ``value``'s shape and dtype when ``value`` is
    array-like (a tensor, a numpy array, anything with ``.shape`` and a
    ``.dtype`` torch or numpy knows); anything else as it is."""
    import numpy as np
    import torch

    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is None or dtype is None:
        return value
    if not isinstance(dtype, torch.dtype):
        from chunkflow_tpu_torch.core.dtypes import torch_dtype

        name = dtype_name(dtype)
        dtype = (torch.bfloat16 if name == "bfloat16"
                 else torch_dtype(np.dtype(name)))
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def check_abstract(fn, *args, **kwargs):
    """Validate ``fn``'s contract, the RESULT's included, without running
    a FLOP: every array-like argument becomes a ``meta`` tensor of its
    shape and dtype and ``fn`` runs on those, so a malformed call fails in
    microseconds instead of after a chunk's worth of card time. Returns
    the abstract result (``meta`` tensors).

    A function that reads tensor VALUES (``.item()``, ``.tolist()``,
    ``.numpy()``, ``nonzero``, a host starts table) cannot run on
    ``meta`` tensors: ``check_abstract`` then raises
    :class:`ContractError` naming the function and the read."""
    meta_args = [_abstract(a) for a in args]
    meta_kwargs = {k: _abstract(v) for k, v in kwargs.items()}
    try:
        return fn(*meta_args, **meta_kwargs)
    except ContractError:
        raise
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        text = str(exc)
        if not (isinstance(exc, NotImplementedError)
                or "meta" in text.lower()):
            raise
        name = getattr(fn, "__qualname__", repr(fn))
        raise ContractError(
            f"{name}: reads tensor values, which check_abstract's meta "
            f"tensors do not hold ({type(exc).__name__}: {text[:200]})"
        ) from exc
