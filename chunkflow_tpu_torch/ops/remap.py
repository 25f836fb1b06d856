"""Segmentation id remapping: the counterpart of ``chunkflow_tpu/ops/remap.py``.

Large uint32/uint64 arrays take the native single-pass hash-table leg
(``csrc/host/remap.cpp``, the port's copy of the JAX package's); every
other array takes the numpy leg (np.unique/searchsorted), which the
native leg equals bitwise. Parity: fastremap.renumber / remap.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# below this the ctypes round trip costs more than numpy's sort
_NATIVE_MIN_SIZE = 1 << 20


def _takes_native(arr: np.ndarray) -> bool:
    return arr.size >= _NATIVE_MIN_SIZE and arr.dtype in (np.uint32,
                                                          np.uint64)


def renumber(arr: np.ndarray, start_id: int = 1) -> Tuple[np.ndarray, Dict[int, int]]:
    """Relabel ids to a compact range [start_id, ...); 0 stays 0.

    Returns the relabeled array and the old->new mapping.
    """
    if _takes_native(arr):
        from chunkflow_tpu_torch import native

        return native.renumber(arr, start_id=start_id)
    # new ids follow FIRST APPEARANCE order (fastremap.renumber semantics)
    ids, first_idx = np.unique(arr, return_index=True)
    keep = ids != 0
    nonzero, first_idx = ids[keep], first_idx[keep]
    order = np.argsort(np.argsort(first_idx, kind="stable"), kind="stable")
    new_ids = (start_id + order).astype(arr.dtype)
    lookup = np.zeros(ids.size, dtype=arr.dtype)
    lookup[np.searchsorted(ids, nonzero)] = new_ids
    out = lookup[np.searchsorted(ids, arr)]
    mapping = {int(o): int(n) for o, n in zip(nonzero, new_ids)}
    return out.astype(arr.dtype), mapping


def remap(arr: np.ndarray, mapping: Dict[int, int], preserve_missing: bool = True) -> np.ndarray:
    """Apply an explicit old->new id mapping."""
    if not mapping:
        return arr.copy()
    if _takes_native(arr):
        from chunkflow_tpu_torch import native

        return native.remap(arr, mapping, preserve_missing=preserve_missing)
    keys = np.array(sorted(mapping.keys()), dtype=arr.dtype)
    vals = np.array([mapping[int(k)] for k in keys], dtype=arr.dtype)
    idx = np.searchsorted(keys, arr)
    idx = np.clip(idx, 0, keys.size - 1)
    found = keys[idx] == arr
    out = np.where(found, vals[idx], arr if preserve_missing else 0)
    return out.astype(arr.dtype)


def remap_arrays(
    arr: np.ndarray,
    keys: np.ndarray,
    values: np.ndarray,
    preserve_missing: bool = True,
) -> np.ndarray:
    """Apply an old->new mapping given as parallel arrays (the
    segmentation plane's remap-table form: millions of rows would make
    the dict path of :func:`remap` allocation-bound). ``keys`` must be
    unique; they are sorted here (with ``values`` carried along) so
    callers can pass tables in any order. Ids absent from ``keys`` pass
    through unchanged (``preserve_missing``) or map to 0."""
    keys = np.asarray(keys)
    values = np.asarray(values)
    if keys.size != values.size:
        raise ValueError(
            f"keys/values length mismatch: {keys.size} vs {values.size}"
        )
    if keys.size == 0:
        return arr.copy() if preserve_missing else np.zeros_like(arr)
    order = np.argsort(keys, kind="stable")
    keys = keys[order].astype(arr.dtype, copy=False)
    values = values[order].astype(arr.dtype, copy=False)
    idx = np.searchsorted(keys, arr)
    idx = np.clip(idx, 0, keys.size - 1)
    found = keys[idx] == arr
    out = np.where(found, values[idx], arr if preserve_missing else 0)
    return out.astype(arr.dtype)


def unique_ids(arr: np.ndarray, return_counts: bool = False):
    """Nonzero unique ids (and counts)."""
    if return_counts:
        ids, counts = np.unique(arr, return_counts=True)
        keep = ids != 0
        return ids[keep], counts[keep]
    ids = np.unique(arr)
    return ids[ids != 0]
