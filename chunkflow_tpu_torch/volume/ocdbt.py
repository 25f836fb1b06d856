"""A read-only OCDBT key-value store over the KV plane.

OCDBT (tensorstore's "optionally cooperative distributed B+tree") is the
store orbax checkpoints write by default: a ``manifest.ocdbt`` at the
root, and data files under ``d/`` holding B+tree nodes, version-tree
nodes and values. :class:`OcdbtKV` reads one through any
:class:`~volume.storage.KVBackend` (a local directory, ``gs://``,
``s3://``), at the newest version its manifest names.

Every manifest and node is one encoded object: a 4-byte big-endian magic
(``0c db 3a 2a`` a manifest, ``0c db 20 de`` a B+tree node, ``0c db 12
34`` a version-tree node), its whole length as a little-endian uint64, a
format version (varint 0), a compression (varint: 0 none, 1 zstd, through
``volume/zstd.py``), the body, and a CRC-32C of everything before it. A
body is columnar: a count, then one field of every entry after another,
integers as LEB128 varints.

- The manifest holds the config (uuid, manifest kind, the largest inline
  value and decoded node, the version tree's arity, the compression), a
  data-file table, the newest versions inline and references to
  version-tree nodes that hold the older ones.
- A data-file table names each file by its base path and its relative
  path (``ocdbt.process_0/`` and ``d/<hex>`` in an orbax root), with
  prefixes shared with the previous entry.
- A B+tree node has a height, a data-file table and its entries' keys
  (each sharing a prefix with the one before). A leaf's entries carry
  their values, inline or as a reference (file, offset, length) read as a
  ranged read of the base KV; an interior node's carry their child's
  reference, statistics and the child's common key prefix, which the
  child's keys leave out. A version with no keys has no root (offset and
  length all ones).

Anything else (a numbered manifest, an unknown format version or
compression) raises ``ValueError``; a write raises.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from chunkflow_tpu_torch.volume import zstd
from chunkflow_tpu_torch.volume.storage import KVBackend

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
MANIFEST = "manifest.ocdbt"
#: the offset and length of a version with no keys, whose root is none
NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """An OCDBT manifest or node that does not decode."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Body:
    """A decoded body, read front to back."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                raise OcdbtError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{len(self.data) - self.pos} bytes after the "
                             f"body")


#: the bound on a decoded manifest or node (tensorstore's
#: ``max_decoded_node_bytes`` is a target it splits nodes at, which a
#: node with one long key passes)
MAX_DECODED = 1 << 30


def decode_object(data: bytes, magic: int) -> bytes:
    """The body of one encoded manifest or node: magic, length, CRC-32C,
    format version and compression checked."""
    if len(data) < 18:
        raise OcdbtError("truncated object")
    got = struct.unpack_from(">I", data)[0]
    if got != magic:
        raise OcdbtError(f"magic {got:#010x}, expected {magic:#010x}")
    if struct.unpack_from("<Q", data, 4)[0] != len(data):
        raise OcdbtError("object length differs from its header")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise OcdbtError("CRC-32C mismatch")
    head = _Body(data[12:-4])
    if head.varint() != 0:
        raise OcdbtError("unknown format version")
    compression = head.varint()
    body = head.data[head.pos:]
    if compression == 1:
        return zstd.decompress(body, max_size=MAX_DECODED)
    if compression != 0:
        raise OcdbtError(f"unknown compression {compression}")
    return body


def _data_files(body: _Body) -> List[Tuple[str, str]]:
    """A data-file table: ``(base path, relative path)`` per file."""
    n = body.varint()
    shared = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    base = body.varints(n)
    files, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError("data-file prefix longer than the path before")
        path = prev[:shared[i]] + body.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError("base path longer than the path")
        files.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return files


def _ref(files, i: int) -> Tuple[str, str]:
    if i >= len(files):
        raise OcdbtError(f"data file {i} of {len(files)}")
    return files[i]


def _versions(body: _Body, files) -> List[dict]:
    n = body.varint()
    generation = body.varints(n)
    height = [body.byte() for _ in range(n)]
    file_ids, offsets, lengths = (body.varints(n) for _ in range(3))
    keys, tree_bytes, indirect = (body.varints(n) for _ in range(3))
    times = body.u64s(n)
    return [{"generation_number": generation[i], "root_height": height[i],
             "root": (None if offsets[i] == NO_ROOT else
                      (_ref(files, file_ids[i]), offsets[i], lengths[i])),
             "statistics": {"num_keys": keys[i],
                            "num_tree_bytes": tree_bytes[i],
                            "num_indirect_value_bytes": indirect[i]},
             "commit_time": times[i]} for i in range(n)]


def _version_nodes(body: _Body, files, heights: Optional[int]) -> List[dict]:
    """References to version-tree nodes (``heights``: every node's height,
    as an interior node's children have; None: a column of them)."""
    n = body.varint()
    generation = body.varints(n)
    file_ids, offsets, lengths = (body.varints(n) for _ in range(3))
    counts = body.varints(n)
    times = body.u64s(n)
    height = ([body.byte() for _ in range(n)] if heights is None
              else [heights] * n)
    return [{"generation_number": generation[i], "height": height[i],
             "location": (_ref(files, file_ids[i]), offsets[i], lengths[i]),
             "num_generations": counts[i], "commit_time": times[i]}
            for i in range(n)]


def _keys(body: _Body, n: int, interior: bool):
    shared = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    common = body.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError("key prefix longer than the key before")
        key = prev[:shared[i]] + body.take(suffix[i])
        if common[i] > len(key):
            raise OcdbtError("subtree prefix longer than its key")
        keys.append(key)
        prev = key
    return keys, common


def decode_btree_node(body_bytes: bytes) -> dict:
    """A B+tree node: ``{"height", "entries"}``; a leaf entry is ``{"key",
    "value"}`` (bytes) or ``{"key", "indirect": ((base, path), offset,
    length)}``, an interior entry ``{"key", "subtree_common_prefix",
    "node": ((base, path), offset, length), "statistics"}``."""
    body = _Body(body_bytes)
    height = body.byte()
    files = _data_files(body)
    n = body.varint()
    keys, common = _keys(body, n, height > 0)
    entries = []
    if height == 0:
        lengths = body.varints(n)
        kinds = body.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError("unknown value kind")
        k = kinds.count(1)
        file_ids, offsets = body.varints(k), body.varints(k)
        indirect = iter(zip(file_ids, offsets))
        for key, length, kind in zip(keys, lengths, kinds):
            if kind:
                file_id, offset = next(indirect)
                entries.append({"key": key, "indirect": (
                    _ref(files, file_id), offset, length)})
            else:
                entries.append({"key": key, "value": None, "length": length})
        for entry in entries:
            if "value" in entry:
                entry["value"] = body.take(entry.pop("length"))
    else:
        file_ids, offsets, lengths = (body.varints(n) for _ in range(3))
        nkeys, tree_bytes, indirect = (body.varints(n) for _ in range(3))
        for i, key in enumerate(keys):
            entries.append({
                "key": key, "subtree_common_prefix": key[:common[i]],
                "node": (_ref(files, file_ids[i]), offsets[i], lengths[i]),
                "statistics": {"num_keys": nkeys[i],
                               "num_tree_bytes": tree_bytes[i],
                               "num_indirect_value_bytes": indirect[i]}})
    body.done()
    return {"height": height, "entries": entries}


def decode_manifest(body_bytes: bytes) -> dict:
    """The manifest: ``{"config", "versions", "version_tree_nodes"}``."""
    body = _Body(body_bytes)
    uuid = body.take(16).hex()
    kind = body.varint()
    if kind != 0:
        raise OcdbtError(f"manifest kind {kind}: the port reads a single "
                         f"manifest.ocdbt")
    config = {"uuid": uuid,
              "max_inline_value_bytes": body.varint(),
              "max_decoded_node_bytes": body.varint(),
              "version_tree_arity_log2": body.byte()}
    method = body.varint()
    if method == 1:
        config["compression"] = {"id": "zstd",
                                 "level": struct.unpack("<i", body.take(4))[0]}
    elif method == 0:
        config["compression"] = {"id": "raw"}
    else:
        raise OcdbtError(f"unknown compression method {method}")
    files = _data_files(body)
    versions = _versions(body, files)
    nodes = _version_nodes(body, files, None)
    body.done()
    return {"config": config, "versions": versions,
            "version_tree_nodes": nodes}


def decode_version_node(body_bytes: bytes) -> dict:
    """A version-tree node: ``{"height", "version_tree_arity_log2",
    "entries"}`` (versions in a leaf, node references above)."""
    body = _Body(body_bytes)
    arity = body.byte()
    height = body.byte()
    files = _data_files(body)
    entries = (_versions(body, files) if height == 0
               else _version_nodes(body, files, height - 1))
    body.done()
    return {"height": height, "version_tree_arity_log2": arity,
            "entries": entries}


class OcdbtKV(KVBackend):
    """The OCDBT store whose root is ``base`` (its ``manifest.ocdbt`` and
    data files), read at the newest version of the manifest read when it
    opens. Nodes are decoded once and kept; values are read on demand,
    an indirect one as a ranged read of its data file. Read only."""

    def __init__(self, base: KVBackend):
        self.base = base
        data = base.read_bytes(MANIFEST)
        if data is None:
            raise FileNotFoundError(f"no {MANIFEST} in the OCDBT root")
        self.manifest = decode_manifest(decode_object(data, MANIFEST_MAGIC))
        self.config = self.manifest["config"]
        self.version = max(self.manifest["versions"],
                           key=lambda v: v["generation_number"],
                           default=None)
        self._nodes: Dict[tuple, dict] = {}
        self._lock = threading.Lock()

    # -- objects --------------------------------------------------------
    def _object(self, location, magic: int) -> bytes:
        (base_path, path), offset, length = location
        data, _ = self.base.read_range(base_path + path, offset,
                                       offset + length)
        if data is None or len(data) != length:
            raise OcdbtError(f"{base_path}{path}: missing or short object "
                             f"at {offset}+{length}")
        return decode_object(data, magic)

    def node(self, location) -> dict:
        with self._lock:
            node = self._nodes.get(location)
        if node is None:
            node = decode_btree_node(self._object(location, BTREE_MAGIC))
            with self._lock:
                self._nodes[location] = node
        return node

    def version_node(self, location) -> dict:
        return decode_version_node(self._object(location, VERSION_MAGIC))

    def versions(self) -> List[dict]:
        """Every version, the oldest first: those in version-tree nodes,
        then the manifest's own."""
        out: List[dict] = []

        def walk(ref):
            node = self.version_node(ref["location"])
            for entry in node["entries"]:
                if node["height"] == 0:
                    out.append(entry)
                else:
                    walk(entry)

        for ref in self.manifest["version_tree_nodes"]:
            walk(ref)
        return sorted(out + self.manifest["versions"],
                      key=lambda v: v["generation_number"])

    # -- the tree ---------------------------------------------------------
    def _entries(self) -> Iterator[Tuple[bytes, dict]]:
        """(full key, leaf entry) of every key, in key order."""
        if self.version is None or self.version["root"] is None:
            return

        def walk(location, prefix):
            node = self.node(location)
            for entry in node["entries"]:
                if node["height"] == 0:
                    yield prefix + entry["key"], entry
                else:
                    yield from walk(entry["node"], prefix
                                    + entry["subtree_common_prefix"])

        yield from walk(self.version["root"], b"")

    def _find(self, name: str) -> Optional[dict]:
        if self.version is None or self.version["root"] is None:
            return None
        key = name.encode()
        location, prefix = self.version["root"], b""
        while True:
            node = self.node(location)
            if node["height"] == 0:
                for entry in node["entries"]:
                    if prefix + entry["key"] == key:
                        return entry
                return None
            chosen = None
            for entry in node["entries"]:
                if prefix + entry["key"] <= key:
                    chosen = entry
                else:
                    break
            if chosen is None:
                return None
            prefix += chosen["subtree_common_prefix"]
            if not key.startswith(prefix):
                return None
            location = chosen["node"]

    def _value(self, entry: dict, start: int = 0,
               stop: Optional[int] = None) -> bytes:
        if "value" in entry:
            return entry["value"][start:stop]
        (base_path, path), offset, length = entry["indirect"]
        stop = length if stop is None else min(stop, length)
        start = min(start, stop)
        data, _ = self.base.read_range(base_path + path, offset + start,
                                       offset + stop)
        if data is None or len(data) != stop - start:
            raise OcdbtError(f"{base_path}{path}: value at {offset}+{length} "
                             f"is missing or short")
        return data

    def keys(self) -> List[str]:
        return [key.decode() for key, _ in self._entries()]

    def items(self) -> Iterator[Tuple[str, bytes]]:
        for key, entry in self._entries():
            yield key.decode(), self._value(entry)

    # -- KVBackend --------------------------------------------------------
    @property
    def generation(self) -> int:
        return self.version["generation_number"] if self.version else 0

    def read_bytes(self, name: str) -> Optional[bytes]:
        entry = self._find(name)
        return None if entry is None else self._value(entry)

    def read_with_generation(self, name: str):
        entry = self._find(name)
        if entry is None:
            return None, 0
        return self._value(entry), self.generation

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        entry = self._find(name)
        if entry is None:
            return None, 0
        return self._value(entry, start, stop), self.generation

    def read_suffix(self, name: str, length: int) -> Optional[bytes]:
        entry = self._find(name)
        if entry is None:
            return None
        size = (len(entry["value"]) if "value" in entry
                else entry["indirect"][2])
        return self._value(entry, max(0, size - length), size)

    def write_bytes(self, name: str, data, if_generation=None) -> None:
        raise NotImplementedError("the port reads OCDBT stores and writes "
                                  "none")

    def delete(self, name: str, if_generation=None) -> None:
        raise NotImplementedError("the port reads OCDBT stores and writes "
                                  "none")

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        return {name: self._find(name) is not None for name in names}

