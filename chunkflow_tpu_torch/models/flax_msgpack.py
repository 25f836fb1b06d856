"""A reader of flax's ``serialization.to_bytes`` files (``.msgpack``).

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
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"


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
