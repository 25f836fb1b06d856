"""CRC-32C (Castagnoli), the checksum of zarr v3's ``crc32c`` codec and
of a ``sharding_indexed`` shard's index.

:func:`crc32c` runs the host C++ (``csrc/host/crc32c.cpp``,
slicing-by-8); :func:`crc32c_plain` is the same function in Python, a
byte at a time, for the tests.
"""
from __future__ import annotations

POLY = 0x82F63B78


def _table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        table.append(c)
    return table


TABLE = _table()


def crc32c(data, crc: int = 0) -> int:
    """The CRC-32C of ``data``, continuing ``crc`` (host C++)."""
    from chunkflow_tpu_torch import native

    return native.crc32c(data, crc)


def crc32c_plain(data, crc: int = 0) -> int:
    """:func:`crc32c` in Python."""
    c = crc ^ 0xFFFFFFFF
    for byte in bytes(data):
        c = (c >> 8) ^ TABLE[(c ^ byte) & 0xFF]
    return c ^ 0xFFFFFFFF
