"""The chunk compressors of zarr v2, zarr v3 and N5: one registry.

Each store names its compressor its own way: zarr v2's ``.zarray``
``compressor`` (``{"id": ...}`` or null), zarr v3's ``codecs`` after
``bytes``, N5's ``compression`` (``{"type": ...}``). All of them map
here onto one of five compressors:

- ``raw``: the bytes as they are;
- ``zlib`` and ``gzip``: the stdlib's ``zlib`` (either stream is read by
  its header);
- ``zstd``: the host C++ decoder (``volume/zstd.py``);
- ``blosc``: the host C++ decoder (``volume/blosc.py``), for every cname
  tensorstore writes (``blosclz``, ``lz4``, ``lz4hc``, ``snappy``,
  ``zlib``, ``zstd``).

A store the port creates writes zlib. A write into an existing blosc
store (tensorstore's default, so every store the JAX ``save-zarr``
creates) stores blosc frames of the zlib codec, byte-shuffled by the
dtype's size (``blosc.compress``), whatever the store's cname. The port
has no zstd encoder: a write into a zstd store raises, as does anything
else unported (zarr v3 ``sharding_indexed``, another compressor id, a
blosc cname tensorstore does not write), naming its ROADMAP item.
"""
from __future__ import annotations

import gzip
import zlib
from typing import Optional, Sequence, Tuple

from chunkflow_tpu_torch.volume import blosc, zstd

ITEM = "ROADMAP, queue 1: chunk file formats"
READS = "raw, zlib, gzip, zstd and blosc"


def not_supported(path: str, what: str):
    raise NotImplementedError(
        f"{path}: {what} is not ported ({ITEM}; the port reads {READS} "
        f"chunks)")


class Compressor:
    """One compressor: ``decode(data, size)`` gives the ``size`` bytes of a
    chunk, ``encode(data)`` the bytes to store."""

    def __init__(self, name: str, level: int = 1, typesize: int = 1,
                 path: str = ""):
        self.name, self.level, self.typesize = name, int(level), typesize
        self.path = path

    def decode(self, data: bytes, size: Optional[int] = None) -> bytes:
        if self.name == "raw":
            return data
        if self.name in ("zlib", "gzip"):
            # wbits 32 + 15: a zlib or a gzip stream, by its header
            return zlib.decompress(data, 47)
        if self.name == "zstd":
            return zstd.decompress(data, size)
        return blosc.decompress(data, size)

    def encode(self, data: bytes) -> bytes:
        if self.name == "raw":
            return data
        if self.name == "zlib":
            return zlib.compress(data, self.level)
        if self.name == "gzip":
            return gzip.compress(data, compresslevel=self.level, mtime=0)
        if self.name == "zstd":
            not_supported(self.path, "writing zstd chunks (the port has "
                                     "no zstd encoder)")
        return blosc.compress(data, self.typesize, self.level)


def _blosc(path: str, config: dict, typesize: int) -> Compressor:
    cname = config.get("cname")
    if cname not in blosc.CNAMES:
        not_supported(path, f"the blosc cname {cname!r}")
    return Compressor("blosc", config.get("clevel", 5), typesize, path)


def from_zarr(path: str, compressor: Optional[dict],
              typesize: int) -> Compressor:
    """A zarr v2 ``compressor``."""
    if compressor is None:
        return Compressor("raw")
    cid = compressor.get("id")
    if cid in ("zlib", "gzip", "zstd"):
        return Compressor(cid, compressor.get("level", 1), path=path)
    if cid == "blosc":
        return _blosc(path, compressor, typesize)
    not_supported(path, f"the {cid} compressor")


def from_zarr3(path: str, codecs: Sequence[dict],
               typesize: int) -> Tuple[str, Compressor]:
    """(the ``bytes`` codec's endian, the compressor after it) of zarr v3
    ``codecs``."""
    names = [c.get("name") for c in codecs]
    if not names or names[0] != "bytes" or len(names) > 2 or \
            names[1:] not in ([], ["gzip"], ["zstd"], ["blosc"]):
        not_supported(path, f"the codecs {names}")
    endian = codecs[0].get("configuration", {}).get("endian", "little")
    if len(names) == 1:
        return endian, Compressor("raw")
    config = codecs[1].get("configuration", {})
    if names[1] == "blosc":
        return endian, _blosc(path, config, typesize)
    return endian, Compressor(names[1], config.get("level", 1), path=path)


def from_n5(path: str, compression: Optional[dict],
            typesize: int) -> Compressor:
    """An N5 ``compression``."""
    kind = (compression or {"type": "raw"}).get("type")
    if kind in ("raw", "gzip", "zstd"):
        return Compressor(kind, (compression or {}).get("level", 1),
                          path=path)
    if kind == "blosc":
        return _blosc(path, compression, typesize)
    not_supported(path, f"the {kind} N5 compression")
