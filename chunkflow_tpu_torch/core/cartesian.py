"""zyx coordinate triple with full elementwise algebra.

A copy of ``chunkflow_tpu/core/cartesian.py`` (numpy only), kept here so
the PyTorch port imports nothing of the JAX package: a ``NamedTuple`` in
(z, y, x) order supporting elementwise arithmetic against scalars, other
triples, and numpy arrays.
"""
from __future__ import annotations

import math
import operator
from typing import NamedTuple, Union

import numpy as np

ScalarOrTriple = Union[int, float, tuple, list, np.ndarray, "Cartesian"]


def _coerce(other: ScalarOrTriple) -> tuple:
    """Broadcast ``other`` to a 3-tuple for elementwise ops."""
    if isinstance(other, (int, float, np.integer, np.floating)):
        return (other, other, other)
    if isinstance(other, np.ndarray):
        other = other.tolist()
    if len(other) != 3:
        raise ValueError(f"expected a scalar or length-3 sequence, got {other!r}")
    return tuple(other)


class Cartesian(NamedTuple):
    """An integer or float coordinate/size triple in (z, y, x) order."""

    z: Union[int, float]
    y: Union[int, float]
    x: Union[int, float]

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_collection(cls, col: ScalarOrTriple) -> "Cartesian":
        return cls(*_coerce(col))

    @classmethod
    def zeros(cls) -> "Cartesian":
        return cls(0, 0, 0)

    @classmethod
    def ones(cls) -> "Cartesian":
        return cls(1, 1, 1)

    # ---- elementwise algebra ------------------------------------------
    def _binop(self, other: ScalarOrTriple, op) -> "Cartesian":
        o = _coerce(other)
        return Cartesian(op(self.z, o[0]), op(self.y, o[1]), op(self.x, o[2]))

    def _rbinop(self, other: ScalarOrTriple, op) -> "Cartesian":
        o = _coerce(other)
        return Cartesian(op(o[0], self.z), op(o[1], self.y), op(o[2], self.x))

    def __add__(self, other):  # type: ignore[override]
        return self._binop(other, operator.add)

    def __radd__(self, other):
        return self._rbinop(other, operator.add)

    def __sub__(self, other):
        return self._binop(other, operator.sub)

    def __rsub__(self, other):
        return self._rbinop(other, operator.sub)

    def __mul__(self, other):  # type: ignore[override]
        return self._binop(other, operator.mul)

    def __rmul__(self, other):  # type: ignore[override]
        return self._rbinop(other, operator.mul)

    def __floordiv__(self, other):
        return self._binop(other, operator.floordiv)

    def __truediv__(self, other):
        return self._binop(other, operator.truediv)

    def __mod__(self, other):
        return self._binop(other, operator.mod)

    def __neg__(self):
        return Cartesian(-self.z, -self.y, -self.x)

    def __invert__(self) -> "Cartesian":
        """Elementwise reciprocal (matches the reference's ``-`` inverse op)."""
        return Cartesian(1.0 / self.z, 1.0 / self.y, 1.0 / self.x)

    # ---- comparisons (all-elementwise; NamedTuple supplies __eq__) ----
    def __lt__(self, other) -> bool:  # type: ignore[override]
        o = _coerce(other)
        return all(s < v for s, v in zip(self, o))

    def __le__(self, other) -> bool:  # type: ignore[override]
        o = _coerce(other)
        return all(s <= v for s, v in zip(self, o))

    def __gt__(self, other) -> bool:  # type: ignore[override]
        o = _coerce(other)
        return all(s > v for s, v in zip(self, o))

    def __ge__(self, other) -> bool:  # type: ignore[override]
        o = _coerce(other)
        return all(s >= v for s, v in zip(self, o))

    # ---- rounding / casting -------------------------------------------
    def ceil(self) -> "Cartesian":
        return Cartesian(*(int(math.ceil(v)) for v in self))

    def floor(self) -> "Cartesian":
        return Cartesian(*(int(math.floor(v)) for v in self))

    def astype_int(self) -> "Cartesian":
        return Cartesian(*(int(v) for v in self))

    def ceildiv(self, other: ScalarOrTriple) -> "Cartesian":
        o = _coerce(other)
        return Cartesian(*(-((-s) // v) for s, v in zip(self, o)))

    def maximum(self, other: ScalarOrTriple) -> "Cartesian":
        return self._binop(other, max)

    def minimum(self, other: ScalarOrTriple) -> "Cartesian":
        return self._binop(other, min)

    # ---- conversions ---------------------------------------------------
    @property
    def inverse(self) -> "Cartesian":
        """Reversed order (zyx <-> xyz), reference spelling."""
        return Cartesian(self.x, self.y, self.z)

    @property
    def vec(self) -> np.ndarray:
        return np.asarray(self)

    @property
    def tuple(self) -> tuple:
        return (self.z, self.y, self.x)

    def prod(self):
        return self.z * self.y * self.x

    def all_positive(self) -> bool:
        return self.z > 0 and self.y > 0 and self.x > 0

    def __repr__(self) -> str:
        return f"Cartesian(z={self.z}, y={self.y}, x={self.x})"


def to_cartesian(value) -> "Cartesian | None":
    """Lenient conversion used at API boundaries; ``None`` passes through."""
    if value is None:
        return None
    if isinstance(value, Cartesian):
        return value
    return Cartesian.from_collection(value)
