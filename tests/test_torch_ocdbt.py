"""The port's OCDBT reader (``volume/ocdbt.py``) against tensorstore's
``ocdbt`` kvstore on the CPU: stores with inline and indirect values,
several commits (versions inline in the manifest and in version-tree
nodes), a small ``max_decoded_node_bytes`` (a B+tree three high, and a
node above it), and an orbax checkpoint's root over ``ocdbt.process_0``. The keys and values
are tensorstore's, and the decoded manifest and nodes are what
``tensorstore.ocdbt.dump`` decodes.
"""
import struct

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.volume.ocdbt import (
    BTREE_MAGIC,
    MANIFEST,
    OcdbtError,
    OcdbtKV,
    crc32c,
    decode_btree_node,
    decode_object,
)
from chunkflow_tpu_torch.volume.storage import FileKV, MemoryKV

ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

torch.set_num_threads(1)


def _location(kind, location):
    (base, path), offset, length = location
    if kind == "value":
        return f"value:{base}:{path}:{offset}:{length}"
    return f"{kind}::{base}{path}:{offset}:{length}"


def _statistics(s):
    return {k: s[k] for k in ("num_indirect_value_bytes", "num_keys",
                              "num_tree_bytes")}


def _as_dump_version(v):
    root = {"statistics": _statistics(v["statistics"])}
    if v["root"] is not None:
        root["location"] = _location("btreenode", v["root"])
    return {"commit_time": v["commit_time"],
            "generation_number": v["generation_number"], "root": root,
            "root_height": v["root_height"]}


def _as_dump_version_node(v):
    return {"commit_time": v["commit_time"],
            "generation_number": v["generation_number"],
            "height": v["height"],
            "location": _location("versionnode", v["location"]),
            "num_generations": v["num_generations"]}


def _as_dump_manifest(m):
    config = dict(m["config"])
    compression = config["compression"]
    if compression["id"] == "raw":
        config.pop("compression")
    elif not compression["level"]:
        config["compression"] = {"id": compression["id"]}
    return {"config": config,
            "versions": [_as_dump_version(v) for v in m["versions"]],
            "version_tree_nodes": [_as_dump_version_node(v)
                                   for v in m["version_tree_nodes"]]}


def _as_dump_node(node):
    entries = []
    for e in node["entries"]:
        if node["height"] == 0 and "value" in e:
            entries.append({"key": e["key"], "inline_value": e["value"]})
        elif node["height"] == 0:
            entries.append({"key": e["key"], "indirect_value": _location(
                "value", e["indirect"])})
        else:
            entries.append({"key": e["key"],
                            "location": _location("btreenode", e["node"]),
                            "statistics": _statistics(e["statistics"]),
                            "subtree_common_prefix":
                                e["subtree_common_prefix"]})
    return {"entries": entries, "height": node["height"]}


def _ts_dump(root, location=None):
    base = ts.KvStore.open({"driver": "file", "path": f"{root}/"}).result()
    dump = ts.ocdbt.dump(base, location).result()
    return _bytes_to_py(dump)


def _bytes_to_py(obj):
    if isinstance(obj, dict):
        return {k: _bytes_to_py(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_bytes_to_py(v) for v in obj]
    return obj


def _assert_same_as_tensorstore(root):
    """Keys, values, ranged reads, the manifest and every node."""
    port = OcdbtKV(FileKV(str(root)))
    ref = ts.KvStore.open({"driver": "ocdbt",
                           "base": f"file://{root}/"}).result()
    keys = sorted(k.decode() for k in ref.list().result())
    assert port.keys() == keys
    for key in keys:
        value = ref.read(key.encode()).result().value
        assert port.read_bytes(key) == value
        assert port.read_range(key, 3, 11)[0] == value[3:11]
    assert port.read_bytes("absent") is None
    assert port.exists_many(keys[:1] + ["absent"]) == {keys[0]: True,
                                                       "absent": False}
    manifest = port.manifest
    dump = _ts_dump(root)
    assert _as_dump_manifest(manifest) == dump
    heights = set()

    def walk(location):
        node = port.node(location)
        heights.add(node["height"])
        assert _as_dump_node(node) == _ts_dump(
            root, _location("btreenode", location))
        for e in node["entries"]:
            if node["height"]:
                walk(e["node"])

    walk(port.version["root"])
    return port, heights


def _store(root, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            "config": config}).result()


def test_inline_and_indirect_values(tmp_path):
    kv = _store(tmp_path, max_inline_value_bytes=64)
    rng = np.random.default_rng(0)
    with ts.Transaction() as txn:
        for i in range(12):
            kv.with_transaction(txn).write(
                f"a/{i:02d}".encode(),
                rng.integers(0, 256, 10 + 17 * i, dtype=np.uint8).tobytes())
    port, _ = _assert_same_as_tensorstore(tmp_path)
    root = port.node(port.version["root"])
    kinds = {"value" in e for e in root["entries"]}
    assert kinds == {True, False}


def test_several_commits_and_a_tall_tree(tmp_path):
    """Eight commits (a version tree of arity 2, so versions in nodes)
    and 200-byte nodes (a B+tree three high)."""
    kv = _store(tmp_path, version_tree_arity_log2=1,
                max_decoded_node_bytes=200, max_inline_value_bytes=100)
    for i in range(8):
        kv.write(f"key{i:03d}/abcdef".encode(), b"v" * (i * 300 + 5)).result()
    port, heights = _assert_same_as_tensorstore(tmp_path)
    assert heights == {0, 1, 2}
    assert [v["generation_number"] for v in port.versions()] == \
        list(range(1, 10))[:len(port.versions())]
    assert len(port.versions()) >= 8
    assert port.manifest["version_tree_nodes"]
    assert port.version["generation_number"] == max(
        v["generation_number"] for v in port.versions())


def test_nodes_above_max_decoded_node_bytes_and_without_a_size(tmp_path):
    """``max_decoded_node_bytes`` is a target tensorstore splits nodes at:
    a node with one long key passes it, and still reads. A zstd node
    whose frame does not state its size decodes as well."""
    kv = _store(tmp_path, max_decoded_node_bytes=200,
                max_inline_value_bytes=100)
    kv.write(b"k" * 600, b"x" * 90).result()
    kv.write(b"j" * 700, b"y" * 90).result()
    port, _ = _assert_same_as_tensorstore(tmp_path)
    location = port.version["root"]
    (_, path), offset, length = location
    node = (tmp_path / path).read_bytes()[offset:offset + length]
    body = decode_object(node, BTREE_MAGIC)
    assert len(body) > 200
    # the same node, its body a zstd frame without its content size
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(body)
    head = node[:12] + bytes([0, 1]) + frame
    head = head[:4] + struct.pack("<Q", len(head) + 4) + head[12:]
    resized = head + struct.pack("<I", crc32c(head))
    assert decode_object(resized, BTREE_MAGIC) == body


def test_an_orbax_root_over_its_process_store(tmp_path):
    """orbax's StandardCheckpointer: a root manifest whose nodes point
    into ``ocdbt.process_0/``."""
    ocp = pytest.importorskip("orbax.checkpoint")
    tree = {"conv": {"kernel": np.arange(3000, dtype=np.float32).reshape(
        10, 300), "bias": np.ones(3, np.float32)}}
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(tmp_path / "ck", tree)
    checkpointer.wait_until_finished()
    root = tmp_path / "ck"
    port, _ = _assert_same_as_tensorstore(root)
    node = port.node(port.version["root"])
    bases = {e["indirect"][0][0] for e in node["entries"]
             if "indirect" in e}
    assert bases == {"ocdbt.process_0/"}
    assert "conv.kernel/.zarray" in port.keys()


def test_writes_and_bad_objects_raise(tmp_path):
    kv = _store(tmp_path)
    kv.write(b"k", b"value").result()
    port = OcdbtKV(FileKV(str(tmp_path)))
    for call in (lambda: port.write_bytes("k", b"x"),
                 lambda: port.delete("k")):
        with pytest.raises(NotImplementedError):
            call()
    data = (tmp_path / MANIFEST).read_bytes()
    base = MemoryKV()
    base.write_bytes(MANIFEST, data[:-1] + bytes([data[-1] ^ 1]))
    with pytest.raises(OcdbtError, match="CRC"):
        OcdbtKV(base)
    (_, path), offset, length = port.version["root"]
    node = (tmp_path / path).read_bytes()[offset:offset + length]
    assert decode_btree_node(decode_object(node, BTREE_MAGIC))
    with pytest.raises(OcdbtError, match="magic"):
        decode_object(node, 0x0CDB3A2A)
    with pytest.raises(FileNotFoundError):
        OcdbtKV(MemoryKV())
