"""The host C++ of the segmentation legs and plane, through ``ctypes``.

The port's copy of ``chunkflow_tpu/native/__init__.py``: connected
components (``csrc/host/cc3d.cpp``), id remapping
(``csrc/host/remap.cpp``), watershed and agglomeration
(``csrc/host/watershed.cpp``) and surface-nets meshing
(``csrc/host/surface_nets.cpp``), with the JAX package's C signatures;
and the precomputed block codecs that run per voxel
(``csrc/host/compressed_segmentation.cpp``: ``compressed_segmentation``
and the PNG row filters, which ``volume/codecs.py`` calls); and the
codecs and the CRC-32C of the zarr, N5 and OCDBT stores
(``csrc/host/zstd.cpp``, ``csrc/host/blosc.cpp``,
``csrc/host/crc32c.cpp``, which ``volume/compressors.py`` calls); and
the ``clahe`` plugin's equalization (``csrc/host/clahe.cpp``, which
``ops/clahe.py`` calls).
The library builds with ``g++`` at first use
(``_build.load(_build.HOST_LIBRARY)``); a failed build raises.
``CHUNKFLOW_NATIVE_THREADS`` sets the z-slab worker count (default: the
cores, at most 8); the labels are the same for every count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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
    lib.watershed_agglomerate.restype = ctypes.c_uint32
    lib.watershed_agglomerate.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.watershed_agglomerate_scored.restype = ctypes.c_uint32
    lib.watershed_agglomerate_scored.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.agglomerate_fragments.restype = ctypes.c_uint32
    lib.agglomerate_fragments.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
        ctypes.c_float, ctypes.c_int]
    lib.surface_nets_mesh_u32.restype = ctypes.c_int32
    lib.surface_nets_mesh_u32.argtypes = [
        ctypes.c_void_p, i64, i64, i64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(i64), ctypes.POINTER(i64)]
    for fn in (lib.cf_renumber_u32, lib.cf_renumber_u64):
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                       ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
                       i64]
    for fn in (lib.cf_remap_u32, lib.cf_remap_u64):
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                       ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_int]
    for fn in (lib.cseg_encode_u32, lib.cseg_encode_u64):
        fn.restype = i64
        fn.argtypes = [ctypes.c_void_p, i64, i64, i64, i64, i64, i64, i64,
                       ctypes.c_void_p, i64]
    for fn in (lib.cseg_decode_u32, lib.cseg_decode_u64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, i64, i64, i64, i64, i64, i64, i64,
                       i64, ctypes.c_void_p]
    lib.png_unfilter.restype = i64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, i64, i64, i64,
                                 ctypes.c_void_p]
    lib.cf_zstd_decompress.restype = i64
    lib.cf_zstd_decompress.argtypes = [ctypes.c_char_p, i64,
                                       ctypes.c_void_p, i64]
    lib.cf_zstd_compress.restype = i64
    lib.cf_zstd_compress.argtypes = [ctypes.c_char_p, i64, ctypes.c_int,
                                     ctypes.c_void_p, i64]
    lib.cf_blosc_decompress.restype = i64
    lib.cf_blosc_decompress.argtypes = [ctypes.c_char_p, i64,
                                        ctypes.c_void_p, i64, _INFLATE]
    for fn in (lib.cf_lz4_compress, lib.cf_blosclz_compress,
               lib.cf_snappy_compress):
        fn.restype = i64
        fn.argtypes = [ctypes.c_char_p, i64, ctypes.c_void_p, i64]
    lib.cf_lz4hc_compress.restype = i64
    lib.cf_lz4hc_compress.argtypes = [ctypes.c_char_p, i64, ctypes.c_void_p,
                                      i64, ctypes.c_int]
    lib.cf_bitshuffle.restype = None
    lib.cf_bitshuffle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, i64, i64]
    for fn in (lib.cf_zstd_error, lib.cf_blosc_error):
        fn.restype = ctypes.c_char_p
        fn.argtypes = [i64]
    lib.cf_clahe_u8.restype = ctypes.c_int
    lib.cf_clahe_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64, i64,
                                i64, ctypes.c_double, ctypes.c_int,
                                ctypes.c_int]
    lib.cf_crc32c.restype = ctypes.c_uint32
    lib.cf_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p, i64]
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


SCORING = {"mean": 0, "max": 1, "min": 2}


def _scoring_code(scoring: str) -> int:
    """``mean``, ``max``, ``min``, or ``quantileN`` (0 <= N <= 100;
    ``quantile50`` is waterz's aff50 median; a 256-bin histogram)."""
    if scoring in SCORING:
        return SCORING[scoring]
    if scoring.startswith("quantile"):
        try:
            q = int(scoring[len("quantile"):])
        except ValueError:
            q = -1
        if 0 <= q <= 100:
            return 100 + q
    raise ValueError(f"scoring must be one of {sorted(SCORING)} or "
                     f"'quantileN' (0<=N<=100), got {scoring!r}")


def watershed_agglomerate(
    affinity: np.ndarray,
    t_high: float = 0.99,
    t_low: float = 0.3,
    merge_threshold: float = 0.5,
    scoring: str = "mean",
    fragments: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int]:
    """Affinity map ``[3, z, y, x]`` float32 -> (segmentation uint32,
    count): seeds above ``t_high``, steepest-ascent fragments above
    ``t_low``, then waterz-style agglomeration of boundaries scoring
    above ``merge_threshold`` by ``scoring``. With ``fragments`` (a
    ``[z, y, x]`` pre-segmentation, 0 = background, ids within uint32)
    only the agglomeration runs."""
    if affinity.ndim != 4 or affinity.shape[0] != 3:
        raise ValueError(f"need [3, z, y, x] affinities, got "
                         f"{affinity.shape}")
    if affinity[0].size >= 1 << 32:
        raise ValueError(
            f"volume of {affinity[0].size} voxels exceeds the native "
            f"kernel's 2^32 voxel addressing; split the chunk first")
    lib = load()
    scoring_code = _scoring_code(scoring)
    aff = np.ascontiguousarray(affinity, dtype=np.float32)
    out = np.empty(aff.shape[1:], dtype=np.uint32)
    if fragments is not None:
        frags = np.asarray(fragments)
        if tuple(frags.shape) != tuple(aff.shape[1:]):
            raise ValueError(f"fragments shape {frags.shape} does not match "
                             f"the affinity volume {aff.shape[1:]}")
        if frags.dtype.kind not in "iu":
            raise TypeError(f"fragments must be integer labels, got "
                            f"{frags.dtype}")
        if frags.size and (int(frags.max()) > 0xFFFFFFFF
                           or int(frags.min()) < 0):
            # a uint32 cast would fuse ids equal mod 2^32
            raise ValueError("fragment labels must fit uint32; renumber "
                             "them first (native.renumber)")
        frags = np.ascontiguousarray(frags, dtype=np.uint32)
        count = lib.agglomerate_fragments(
            aff.ctypes.data, frags.ctypes.data, out.ctypes.data,
            *aff.shape[1:], float(merge_threshold), scoring_code)
        return out, int(count)
    count = lib.watershed_agglomerate_scored(
        aff.ctypes.data, out.ctypes.data, *aff.shape[1:], float(t_high),
        float(t_low), float(merge_threshold), scoring_code)
    return out, int(count)


def mesh_object(seg: np.ndarray,
                obj_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Surface-nets mesh of one object: (vertices ``[N, 3]`` float32,
    xyz in voxel units; faces ``[M, 3]`` uint32). As in the JAX package,
    the labels are cast to uint32 and the id passed as ``c_uint32``:
    ids equal mod 2^32 mesh as one object."""
    lib = load()
    seg = np.ascontiguousarray(seg, dtype=np.uint32)
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    lib.surface_nets_mesh_u32(seg.ctypes.data, *seg.shape, int(obj_id),
                              None, None, ctypes.byref(nv),
                              ctypes.byref(nf))
    vertices = np.empty((nv.value, 3), dtype=np.float32)
    faces = np.empty((nf.value, 3), dtype=np.uint32)
    lib.surface_nets_mesh_u32(
        seg.ctypes.data, *seg.shape, int(obj_id),
        vertices.ctypes.data if nv.value else None,
        faces.ctypes.data if nf.value else None,
        ctypes.byref(nv), ctypes.byref(nf))
    return vertices, faces


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


def _cseg_fns(dtype: np.dtype):
    lib = load()
    fns = {np.dtype(np.uint32): (lib.cseg_encode_u32, lib.cseg_decode_u32),
           np.dtype(np.uint64): (lib.cseg_encode_u64, lib.cseg_decode_u64)}
    if np.dtype(dtype) not in fns:
        raise ValueError(f"compressed_segmentation holds uint32 or uint64 "
                         f"labels, not {np.dtype(dtype).name}")
    return fns[np.dtype(dtype)]


def compressed_segmentation_encode(block: np.ndarray,
                                   block_size_zyx) -> bytes:
    """A ``[c, z, y, x]`` uint32/uint64 chunk as compressed_segmentation
    bytes, in blocks of ``block_size_zyx``."""
    encode, _ = _cseg_fns(block.dtype)
    block = np.ascontiguousarray(block)
    c, z, y, x = block.shape
    bz, by, bx = (int(v) for v in block_size_zyx)
    blocks = -(-z // bz) * -(-y // by) * -(-x // bx)
    words = block.dtype.itemsize // 4
    # header, and per block its two words, its values at 32 bits at the
    # most and a table of every voxel
    capacity = c * (1 + blocks * (2 + bz * by * bx * (1 + words)))
    out = np.empty(capacity, dtype=np.uint32)
    n = encode(block.ctypes.data, c, z, y, x, bz, by, bx, out.ctypes.data,
               capacity)
    if n < 0:
        raise RuntimeError(f"compressed_segmentation: {-n} words do not "
                           f"fit the {capacity}-word bound")
    return out[:n].astype("<u4", copy=False).tobytes()


def compressed_segmentation_decode(data: bytes, shape_czyx, dtype,
                                   block_size_zyx) -> np.ndarray:
    """compressed_segmentation bytes as a ``[c, z, y, x]`` array; a chunk
    whose offsets, bit widths or indices leave its bytes raises
    ``ValueError``."""
    _, decode = _cseg_fns(dtype)
    if len(data) % 4:
        raise ValueError(f"compressed_segmentation chunk of {len(data)} "
                         f"bytes is not whole 32-bit words")
    words = np.frombuffer(data, dtype="<u4")
    c, z, y, x = (int(v) for v in shape_czyx)
    out = np.empty((c, z, y, x), dtype=dtype)
    if decode(words.ctypes.data, words.size, c, z, y, x,
              *(int(v) for v in block_size_zyx), out.ctypes.data) != 0:
        raise ValueError("corrupt compressed_segmentation chunk")
    return out


def png_unfilter(filtered: np.ndarray, rows: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``rows`` rows of ``stride`` bytes,
    each led by its filter byte, ``bpp`` bytes per pixel."""
    filtered = np.ascontiguousarray(filtered, dtype=np.uint8)
    if filtered.size != rows * (stride + 1):
        raise ValueError(f"PNG image data of {filtered.size} bytes, "
                         f"expected {rows * (stride + 1)}")
    out = np.empty(rows * stride, dtype=np.uint8)
    bad = load().png_unfilter(filtered.ctypes.data, rows, stride, bpp,
                              out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {-bad - 1} has an unknown filter type")
    return out


#: cf_zstd_decompress's code for frames that do not fit the output
_ZSTD_OUTPUT_FULL = -6


class ZstdOutputFull(ValueError):
    """zstd frames that decode to more bytes than the output holds."""


def zstd_decompress(data: bytes, size: int, exact: bool = True) -> bytes:
    """The frames in ``data`` decoded into ``size`` bytes (``exact``) or
    at most ``size``; a frame that does not decode, or decodes to another
    size, raises ``ValueError`` (:class:`ZstdOutputFull` where the frames
    do not fit ``size`` bytes)."""
    lib = load()
    out = np.empty(size, dtype=np.uint8)
    n = lib.cf_zstd_decompress(data, len(data), out.ctypes.data, size)
    if n < 0:
        error = ZstdOutputFull if n == _ZSTD_OUTPUT_FULL else ValueError
        raise error(f"zstd: {lib.cf_zstd_error(n).decode()}")
    if exact and n != size:
        raise ValueError(f"zstd: frames of {n} bytes where {size} were "
                         f"expected")
    return out[:n].tobytes()


def zstd_compress(data: bytes, level: int) -> bytes:
    """``data`` as one zstd frame at ``level``."""
    lib = load()
    # a frame is never larger than its blocks stored raw
    cap = len(data) + 3 * (len(data) // (128 * 1024) + 1) + 32
    out = np.empty(cap, dtype=np.uint8)
    n = lib.cf_zstd_compress(data, len(data), int(level), out.ctypes.data,
                             cap)
    if n < 0:
        raise ValueError(f"zstd: {lib.cf_zstd_error(n).decode()}")
    return out[:n].tobytes()


#: a zlib stream's decoder for the host C++: (source, its size, output,
#: its capacity) -> bytes written, or a negative code
_INFLATE = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_int64)


def _inflate_stream(src, n, dst, cap):
    """A blosc frame's zlib stream (the library links no zlib)."""
    import zlib

    try:
        data = zlib.decompress(ctypes.string_at(src, n))
    except zlib.error:
        return -5
    if len(data) > cap:
        return -4
    ctypes.memmove(dst, data, len(data))
    return len(data)


# kept for the life of the process: the host C++ calls it
_inflate = _INFLATE(_inflate_stream)


def blosc_decompress(data: bytes, expect: Optional[int] = None) -> bytes:
    """The blosc frame ``data`` decoded; a frame that does not decode, or
    whose size is not ``expect`` (where given), raises ``ValueError``."""
    lib = load()
    if len(data) < 16:
        raise ValueError("blosc: truncated frame")
    size = int.from_bytes(data[4:8], "little")
    if expect is not None and size != expect:
        raise ValueError(f"blosc: a frame of {size} bytes where {expect} "
                         f"were expected")
    out = np.empty(size, dtype=np.uint8)
    n = lib.cf_blosc_decompress(data, len(data), out.ctypes.data, size,
                                _inflate)
    if n < 0:
        raise ValueError(f"blosc: {lib.cf_blosc_error(n).decode()}")
    return out.tobytes()


def _stream(fn, name: str, data: bytes, cap: int) -> bytes:
    out = np.empty(cap, dtype=np.uint8)
    n = fn(data, len(data), out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"{name}: {load().cf_blosc_error(n).decode()}")
    return out[:n].tobytes()


def lz4_compress(data: bytes) -> bytes:
    """``data`` as one LZ4 block."""
    # the LZ4 block format's bound on its output
    return _stream(load().cf_lz4_compress, "lz4", data,
                   len(data) + len(data) // 255 + 16)


def lz4hc_compress(data: bytes, depth: int) -> bytes:
    """``data`` as one LZ4 block, each match the longest of ``depth``
    candidates (LZ4 HC's search)."""
    lib = load()
    return _stream(lambda *a: lib.cf_lz4hc_compress(*a, int(depth)),
                   "lz4hc", data, len(data) + len(data) // 255 + 16)


def blosclz_compress(data: bytes) -> bytes:
    """``data`` (not empty) as one blosclz stream."""
    # a control byte for every 32 literals
    return _stream(load().cf_blosclz_compress, "blosclz", data,
                   len(data) + len(data) // 32 + 16)


def snappy_compress(data: bytes) -> bytes:
    """``data`` as one snappy stream."""
    # snappy's own bound: a tag per 60 literals, the varint length
    return _stream(load().cf_snappy_compress, "snappy", data,
                   len(data) + len(data) // 6 + 32)


def bitshuffle(data: bytes, typesize: int) -> bytes:
    """One blosc block bit-shuffled by ``typesize``; a block of a count of
    elements that is not a multiple of 8 comes back as it is."""
    out = np.empty(len(data), dtype=np.uint8)
    load().cf_bitshuffle(data, out.ctypes.data, int(typesize), len(data))
    return out.tobytes()


def clahe(sections: np.ndarray, clip_limit: float, tile_size: int,
          threads: Optional[int] = None) -> np.ndarray:
    """CLAHE of each uint8 section of a C-contiguous ``[z, y, x]`` array
    (``ops/clahe.py`` checks the arguments) on ``threads`` workers
    (default ``CHUNKFLOW_NATIVE_THREADS``, else the cores, at most 8);
    the result is the same for every count."""
    import os

    if threads is None:
        threads = int(os.environ.get("CHUNKFLOW_NATIVE_THREADS", "0")) or \
            min(os.cpu_count() or 1, 8)
    out = np.empty_like(sections)
    if load().cf_clahe_u8(sections.ctypes.data, out.ctypes.data,
                          *sections.shape, float(clip_limit), int(tile_size),
                          max(int(threads), 1)):
        raise ValueError(f"CLAHE of {sections.shape} sections on a "
                         f"{tile_size} x {tile_size} grid")
    return out


def crc32c(data, crc: int = 0) -> int:
    """The CRC-32C of ``data`` (bytes or a buffer), continuing ``crc``."""
    data = bytes(data)
    return int(load().cf_crc32c(crc, data, len(data)))
