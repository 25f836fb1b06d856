"""flax's ``serialization.to_bytes`` files (``.msgpack``), read and
written.

The JAX package saves params with ``flax.serialization.to_bytes``: the
param tree as a msgpack map of maps whose leaves are numpy arrays in
msgpack's extension type 1, each holding a nested msgpack array
``(shape, dtype name, row-major bytes)``. An array larger than 2**30
bytes is cut into a map ``{"__msgpack_chunked_array__": True, "shape":
{"0": d0, ...}, "chunks": {"0": flat part, ...}}``. This module decodes
that subset of msgpack (https://github.com/msgpack/msgpack/blob/master/
spec.md) by itself, so the port needs no ``msgpack`` package: maps,
arrays, str, bin, nil, booleans, ints, floats and extension type 1.
Arrays come back as numpy arrays (``bfloat16`` as a torch tensor: numpy
has no such type).

:func:`dumps` writes the bytes of flax's ``to_bytes``: lists and tuples
as maps of ``"0"``, ``"1"``, ... (flax's state dict), maps in their
insertion order, ints in the narrowest msgpack width, floats as doubles,
str and bin by their length, and each array leaf (numpy, or a torch
tensor; a ``bfloat16`` one as its bits named ``"bfloat16"``) in extension
type 1; an array leaf of a map above :data:`MAX_CHUNK_SIZE` bytes is cut
as flax cuts it.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"
#: flax's ``serialization.MAX_CHUNK_SIZE``: an array leaf of a map above
#: this many bytes is written in flat parts of at most this many
MAX_CHUNK_SIZE = 2 ** 30


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in fixed:
            return fixed[tag]
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                  0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                  0xD2: ">i", 0xD3: ">q"}
        if tag in scalar:
            return self.unpack(scalar[tag])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if tag in sized:
            n = self.unpack(sized[tag])
            if tag <= 0xC6:
                return bytes(self.take(n))
            if tag <= 0xC9:
                return self.ext(n)
            if tag <= 0xDB:
                return self.str(n)
            if tag <= 0xDD:
                return self.array(n)
            return self.map(n)
        if 0xD4 <= tag <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (tag - 0xD4))
        raise ValueError(f"msgpack type byte 0x{tag:02x} is not supported")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack extension type {code} is not a flax "
                             f"ndarray (type {_EXT_NDARRAY})")
        return _ndarray(bytes(payload))


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    shape, name, buffer = _Reader(payload).value()
    if isinstance(name, bytes):
        name = name.decode()
    shape: Tuple[int, ...] = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {key: _unchunk(value) for key, value in tree.items()}
    return tree


def loads(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``: nested dicts with array leaves, chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack value")
    return _unchunk(tree)


def load(path: str):
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------
def _array(leaf) -> Tuple[np.ndarray, str]:
    """(the C-order values, the dtype name flax writes) of an array leaf:
    a ``bfloat16`` tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        leaf = leaf.numpy()
    return leaf, leaf.dtype.name


def _header(out: bytearray, n: int, fix: int, limit: int,
            tags: Tuple[int, ...]) -> None:
    """A length: in the ``fix`` tag below ``limit``, else after the first
    of ``tags`` (8-, 16-, 32-bit) that holds it."""
    if fix is not None and n < limit:
        out.append(fix | n)
        return
    for tag, fmt in zip(tags, (">B", ">H", ">I")[3 - len(tags):]):
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"a msgpack length of {n} does not fit 32 bits")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    widths = ((0xCC, ">B", 0xD0, ">b"), (0xCD, ">H", 0xD1, ">h"),
              (0xCE, ">I", 0xD2, ">i"), (0xCF, ">Q", 0xD3, ">q"))
    for utag, ufmt, stag, sfmt in widths:
        bits = 8 * struct.calcsize(ufmt)
        if 0 <= v < 1 << bits:
            out.append(utag)
            out += struct.pack(ufmt, v)
            return
        if -(1 << (bits - 1)) <= v < 0:
            out.append(stag)
            out += struct.pack(sfmt, v)
            return
    raise OverflowError(f"{v} does not fit a msgpack int")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(leaf) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, bytes)``."""
    arr, name = _array(leaf)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not written")
    out = bytearray()
    _pack(out, [list(arr.shape), name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, value) -> None:
    """msgpack-python's ``packb`` with ``use_bin_type`` and
    ``strict_types``, an array leaf in extension type 1."""
    kind = type(value)
    if value is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if value else 0xC2)
    elif kind is int:
        _int(out, value)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif kind is str:
        data = value.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif kind in (bytes, bytearray, memoryview):
        data = bytes(value)
        _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif kind is list:
        _header(out, len(value), 0x90, 16, (0xDC, 0xDD))
        for item in value:
            _pack(out, item)
    elif kind is dict:
        _header(out, len(value), 0x80, 16, (0xDE, 0xDF))
        for key, item in value.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(value))
    else:
        raise TypeError(f"cannot write a {kind.__name__} into a flax "
                        f"msgpack file")


def _chunked(leaf) -> dict:
    """flax's ``_chunk``: an array as flat parts of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    arr, name = _array(leaf)
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    parts = [flat[i:i + size] for i in range(0, flat.size, size)]
    if name == "bfloat16":
        parts = [torch.from_numpy(p.view(np.int16)).view(torch.bfloat16)
                 for p in parts]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(parts)}}


def _cut(tree):
    """flax's ``_chunk_array_leaves_in_place`` on a copy: the array leaves
    of maps (and a tree that is one array) above :data:`MAX_CHUNK_SIZE`
    bytes, cut."""
    def big(leaf) -> bool:
        if not isinstance(leaf, (np.ndarray, torch.Tensor)):
            return False
        arr, _ = _array(leaf)
        return arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE

    if isinstance(tree, dict):
        return {key: _chunked(value) if big(value) else
                (_cut(value) if isinstance(value, dict) else value)
                for key, value in tree.items()}
    return _chunked(tree) if big(tree) else tree


def _state_dict(tree):
    """flax's ``to_state_dict``: str keys, lists and tuples as maps."""
    if isinstance(tree, dict):
        return {str(key): _state_dict(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(value) for i, value in enumerate(tree)}
    return tree


def dumps(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` gives for ``tree``:
    nested dicts, lists and tuples with Python scalars, str, bytes and
    array leaves (numpy arrays or torch tensors)."""
    out = bytearray()
    _pack(out, _cut(_state_dict(tree)))
    return bytes(out)


def dump(tree, path: str) -> str:
    """Write :func:`dumps` of ``tree`` to ``path``; returns ``path``."""
    with open(path, "wb") as f:
        f.write(dumps(tree))
    return path
