"""The host C++ of the segmentation legs, through ``ctypes``.

The port's copy of ``chunkflow_tpu/native/__init__.py`` for connected
components (``csrc/host/cc3d.cpp``) and id remapping
(``csrc/host/remap.cpp``). The library builds with ``g++`` at first use
(``_build.load(_build.HOST_LIBRARY)``); a failed build raises.
``CHUNKFLOW_NATIVE_THREADS`` sets the z-slab worker count (default: the
cores, at most 8); the labels are the same for every count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from chunkflow_tpu_torch import _build

_lib = None


def load() -> ctypes.CDLL:
    """The built library, its functions' argument and result types
    declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(_build.HOST_LIBRARY)
    i64 = ctypes.c_int64
    for fn in (lib.cc3d_label_u8, lib.cc3d_label_u32, lib.cc3d_label_u64):
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
                       ctypes.c_int]
    for fn in (lib.cf_renumber_u32, lib.cf_renumber_u64):
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                       ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
                       i64]
    for fn in (lib.cf_remap_u32, lib.cf_remap_u64):
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                       ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_int]
    _lib = lib
    return lib


def connected_components(arr: np.ndarray,
                         connectivity: int = 26) -> Tuple[np.ndarray, int]:
    """Label distinct-value 3D regions; returns (labels uint32, count).
    Components are numbered by their first voxel in raster order."""
    if connectivity not in (6, 18, 26):
        raise ValueError(f"connectivity must be 6/18/26, got {connectivity}")
    if arr.size >= 1 << 32:
        # voxel-index union-find addresses voxels as uint32
        raise ValueError(
            f"volume of {arr.size} voxels exceeds the native kernel's "
            f"2^32 voxel addressing; split the chunk first")
    lib = load()
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    fns = {
        np.dtype(np.uint8): lib.cc3d_label_u8,
        np.dtype(np.uint32): lib.cc3d_label_u32,
        np.dtype(np.uint64): lib.cc3d_label_u64,
    }
    if arr.dtype not in fns:
        if arr.dtype.kind not in "iu":
            raise TypeError(f"unsupported dtype for labeling: {arr.dtype}")
        arr = arr.astype(np.uint64)
    out = np.empty(arr.shape, dtype=np.uint32)
    count = fns[arr.dtype](arr.ctypes.data, out.ctypes.data, *arr.shape,
                           connectivity)
    return out, int(count)


def renumber(arr: np.ndarray, start_id: int = 1):
    """Compact-relabel a uint32/uint64 segmentation (0 stays 0) in first
    appearance order, one hash-table pass. Returns (relabeled,
    {old: new})."""
    lib = load()
    flat = np.ascontiguousarray(arr).reshape(-1)
    fns = {
        np.dtype(np.uint32): lib.cf_renumber_u32,
        np.dtype(np.uint64): lib.cf_renumber_u64,
    }
    if flat.dtype not in fns:
        raise TypeError(f"native renumber supports uint32/uint64, got "
                        f"{flat.dtype}")
    out = np.empty_like(flat)
    # a generous first buffer (<= 64 MB): a retry repeats the O(n) pass
    max_pairs = min(flat.size, 1 << 22) or 1
    while True:
        keys = np.empty(max_pairs, dtype=np.uint64)
        vals = np.empty(max_pairs, dtype=np.uint64)
        n = fns[flat.dtype](flat.ctypes.data, out.ctypes.data, flat.size,
                            int(start_id), keys.ctypes.data,
                            vals.ctypes.data, max_pairs)
        if n >= 0:
            break
        max_pairs = -n
    if n and int(start_id) + n - 1 > np.iinfo(flat.dtype).max:
        raise OverflowError(f"renumbered ids exceed {flat.dtype} "
                            f"(start_id={start_id}, {n} labels)")
    mapping = dict(zip(keys[:n].tolist(), vals[:n].tolist()))
    return out.reshape(arr.shape), mapping


def remap(arr: np.ndarray, mapping: Dict[int, int],
          preserve_missing: bool = True) -> np.ndarray:
    """Apply an explicit old->new id mapping to a uint32/uint64 array."""
    lib = load()
    flat = np.ascontiguousarray(arr).reshape(-1)
    fns = {
        np.dtype(np.uint32): lib.cf_remap_u32,
        np.dtype(np.uint64): lib.cf_remap_u64,
    }
    if flat.dtype not in fns:
        raise TypeError(f"native remap supports uint32/uint64, got "
                        f"{flat.dtype}")
    keys = np.fromiter(mapping.keys(), dtype=np.uint64, count=len(mapping))
    vals = np.fromiter(mapping.values(), dtype=np.uint64, count=len(mapping))
    if vals.size and int(vals.max()) > np.iinfo(flat.dtype).max:
        # the numpy leg raises here too; the C++ cast would wrap
        raise OverflowError(f"mapping value {int(vals.max())} does not fit "
                            f"{flat.dtype}")
    out = np.empty_like(flat)
    fns[flat.dtype](flat.ctypes.data, out.ctypes.data, flat.size,
                    keys.ctypes.data, vals.ctypes.data, keys.size,
                    1 if preserve_missing else 0)
    return out.reshape(arr.shape)
