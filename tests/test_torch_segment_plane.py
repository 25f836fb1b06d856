"""The segmentation plane on the CPU, port against JAX.

``tests/segment/``'s and ``tests/parallel/test_tree_source.py``'s cases
run through both packages in one process on seeded numpy inputs: the
stitched volumes bitwise the JAX package's on the host leg (and so
label-isomorphic to it and to a monolithic labelling), the device leg on
the CPU bitwise the JAX device leg, the sidecars and job directories
byte for byte, the merge tables bitwise; the seven commands through both
CLIs; a port worker killed at ``segment/merge`` and a JAX coordinator
drained by a port worker, as subprocesses; and every ``--device`` path
raising on a box without a card.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.ops import connected_components as jax_cc
from chunkflow_tpu.parallel import lifecycle as jax_lifecycle
from chunkflow_tpu.parallel import queues as jax_queues
from chunkflow_tpu.parallel.task_tree import SpatialTaskTree as JaxTree
from chunkflow_tpu.parallel.tree_source import TreeTaskSource as JaxSource
from chunkflow_tpu.segment import driver as jax_driver
from chunkflow_tpu.segment import merge_table as jax_mt
from chunkflow_tpu.segment import stages as jax_stages
from chunkflow_tpu.segment.plan import SegmentPlan as JaxPlan
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.parallel.lifecycle import (
    FileLedger,
    MemoryLedger,
    open_ledger,
)
from chunkflow_tpu_torch.parallel.queues import open_queue
from chunkflow_tpu_torch.parallel.task_tree import SpatialTaskTree
from chunkflow_tpu_torch.parallel.tree_source import TreeTaskSource
from chunkflow_tpu_torch.segment import (
    labels_isomorphic,
    open_store,
    segment_volume,
)
from chunkflow_tpu_torch.segment import driver, stages
from chunkflow_tpu_torch.segment import merge_table as mt
from chunkflow_tpu_torch.segment.driver import export_segmentation, run_local
from chunkflow_tpu_torch.segment.plan import SegmentPlan
from chunkflow_tpu_torch.segment.stages import (
    LABEL_DTYPE,
    SegmentStore,
    label_chunk,
    merge_node,
    relabel_chunk,
)
from chunkflow_tpu_torch.volume.storage import (
    KVArrayBackend,
    MemoryBackend,
    MemoryKV,
    blockwise_cutout,
    blockwise_save,
)

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAS_CARD = torch.cuda.is_available()


def _monolithic(arr, connectivity, multivalue=False, threshold=0.5):
    if multivalue:
        return jax_cc.label_multivalue(arr, connectivity=connectivity)
    if np.dtype(arr.dtype).kind == "f":
        return jax_cc.label_binary(arr > threshold,
                                   connectivity=connectivity)
    return jax_cc.label_binary(arr != 0, connectivity=connectivity)


def _both(arr, chunk, **kw):
    """(port, JAX) stitched volumes of one input and knobs."""
    got = segment_volume(arr, chunk, **kw)
    want = jax_driver.segment_volume(arr, chunk, **kw)
    assert got.dtype == want.dtype == LABEL_DTYPE
    return got, want


# ---------------------------------------------------------------------------
# stitching: tests/segment/test_stitching.py's cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("shape,chunk", [
    ((24, 24, 24), (8, 8, 8)),
    ((13, 17, 9), (5, 6, 4)),
    ((7, 20, 6), (7, 6, 6)),
])
def test_binary_stitch_is_the_jax_packages(connectivity, shape, chunk):
    rng = np.random.default_rng(connectivity * 100 + shape[0])
    dense = (rng.random(shape) > 0.62).astype(np.float32)
    got, want = _both(dense, chunk, connectivity=connectivity, workers=3)
    assert np.array_equal(got, want)
    assert labels_isomorphic(got, _monolithic(dense, connectivity))


@pytest.mark.parametrize("connectivity", [6, 26])
def test_multivalue_stitch_is_the_jax_packages(connectivity):
    rng = np.random.default_rng(connectivity)
    ids = rng.integers(0, 4, size=(14, 11, 10)).astype(np.uint32)
    got, want = _both(ids, (6, 5, 4), connectivity=connectivity,
                      multivalue=True, workers=2)
    assert np.array_equal(got, want)
    assert labels_isomorphic(got, _monolithic(ids, connectivity,
                                              multivalue=True))


def test_single_chunk_grid_degenerates_cleanly():
    rng = np.random.default_rng(0)
    dense = (rng.random((6, 6, 6)) > 0.5).astype(np.float32)
    got, want = _both(dense, (8, 8, 8), connectivity=26)
    assert np.array_equal(got, want)
    assert labels_isomorphic(got, _monolithic(dense, 26))


@pytest.mark.parametrize("connectivity, threshold", [(26, 0.6), (6, 0.45)])
def test_device_leg_on_the_cpu_is_the_jax_device_leg(connectivity,
                                                     threshold):
    """The device leg labels each chunk by propagation (here on the CPU):
    bitwise the JAX device leg, isomorphic to the host leg."""
    rng = np.random.default_rng(2)
    dense = rng.random((12, 12, 12)).astype(np.float32)
    got = segment_volume(dense, (6, 6, 6), connectivity=connectivity,
                         threshold=threshold, device="cpu", workers=2)
    want = jax_driver.segment_volume(dense, (6, 6, 6),
                                     connectivity=connectivity,
                                     threshold=threshold, device=True,
                                     workers=1)
    assert np.array_equal(got, want)
    host = segment_volume(dense, (6, 6, 6), connectivity=connectivity,
                          threshold=threshold)
    assert labels_isomorphic(got, host)
    assert labels_isomorphic(got, _monolithic(dense, connectivity,
                                              threshold=threshold))


def test_empty_and_full_volumes():
    zeros = np.zeros((9, 9, 9), dtype=np.uint8)
    got, want = _both(zeros, (4, 4, 4))
    assert not got.any() and not want.any()
    ones = np.ones((9, 9, 9), dtype=np.uint8)
    got, want = _both(ones, (4, 4, 4), connectivity=6)
    assert np.array_equal(got, want)
    assert got.all() and np.unique(got).size == 1


def _kv_store(pkg, arr, start, chunk, connectivity=26):
    """A store over a nonzero-offset domain, input and labels in
    KVArrayBackends (the multi-process layout, in memory)."""
    if pkg == "port":
        box, plan_cls, store_cls = BoundingBox, SegmentPlan, SegmentStore
        kvab, kv, save = KVArrayBackend, MemoryKV, blockwise_save
    else:
        box, plan_cls, store_cls = JaxBox, JaxPlan, jax_stages.SegmentStore
        kvab, kv = jax_storage.KVArrayBackend, jax_storage.MemoryKV
        save = jax_storage.blockwise_save
    stop = tuple(s + d for s, d in zip(start, arr.shape))
    plan = plan_cls(box(start, stop), chunk)
    input_b = kvab(kv(), domain=(start, stop), dtype=arr.dtype,
                   block_shape=chunk, prefix="in")
    save(input_b, start, arr)
    seg_b = kvab(kv(), domain=(start, stop), dtype=LABEL_DTYPE,
                 block_shape=chunk, prefix="seg")
    return store_cls(plan, input_b, seg_b, kv(), connectivity=connectivity)


def test_nonzero_offset_domain():
    rng = np.random.default_rng(5)
    arr = (rng.random((13, 10, 11)) > 0.6).astype(np.uint8)
    start = (32, 7, 129)
    stop = tuple(s + d for s, d in zip(start, arr.shape))
    store = _kv_store("port", arr, start, (5, 4, 6))
    run_local(store, workers=2)
    jax_store = _kv_store("jax", arr, start, (5, 4, 6))
    jax_driver.run_local(jax_store, workers=2)
    out = blockwise_cutout(store.seg_backend, start, stop)
    assert np.array_equal(out, jax_storage.blockwise_cutout(
        jax_store.seg_backend, start, stop))
    assert labels_isomorphic(out, _monolithic(arr, 26))
    assert store.kv._data == jax_store.kv._data


def test_every_stage_replays_identically():
    """A redelivered task reruns in full and rewrites the same bytes;
    after each phase the sidecars are the JAX package's, byte for
    byte."""
    rng = np.random.default_rng(6)
    arr = (rng.random((12, 10, 8)) > 0.55).astype(np.uint8)
    store = _kv_store("port", arr, (0, 0, 0), (6, 5, 4))
    jax_store = _kv_store("jax", arr, (0, 0, 0), (6, 5, 4))
    plan = store.plan

    def snapshot():
        return (dict(store.kv._data),
                blockwise_cutout(store.seg_backend, plan.bbox.start,
                                 plan.bbox.stop))

    def assert_unchanged(before):
        kv_after, seg_after = snapshot()
        assert np.array_equal(before[1], seg_after)
        assert kv_after == before[0]
        assert kv_after == jax_store.kv._data

    for chunk in plan.chunks:
        label_chunk(store, chunk)
        jax_stages.label_chunk(jax_store, JaxBox.from_string(chunk.string))
    before = snapshot()
    label_chunk(store, plan.chunks[0])
    assert_unchanged(before)

    interior = [n.bbox for n in plan.make_tree().post_order()
                if not n.is_leaf]
    for bbox in interior:
        merge_node(store, bbox)
        jax_stages.merge_node(jax_store, JaxBox.from_string(bbox.string))
    before = snapshot()
    merge_node(store, interior[0])
    merge_node(store, interior[-1])  # the root rewrites the remap too
    assert_unchanged(before)

    for chunk in plan.chunks:
        relabel_chunk(store, chunk)
        jax_stages.relabel_chunk(jax_store, JaxBox.from_string(chunk.string))
    before = snapshot()
    relabel_chunk(store, plan.chunks[-1])
    assert_unchanged(before)


def test_every_grid_interface_is_covered_exactly_once():
    roi = BoundingBox((0, 0, 0), (13, 17, 9))
    plan = SegmentPlan(roi, (5, 6, 4))
    jax_plan = JaxPlan(JaxBox((0, 0, 0), (13, 17, 9)), (5, 6, 4))
    shape = tuple(int(s) for s in roi.shape)
    coverage = {}
    for node, jax_node in zip(plan.make_tree().walk(),
                              jax_plan.make_tree().walk()):
        assert node.bbox.string == jax_node.bbox.string
        if node.is_leaf:
            continue
        axis, split, low, high = plan.plane_chunks(node)
        want = jax_plan.plane_chunks(jax_node)
        assert (axis, split) == want[:2]
        assert [c.string for c in low] == [c.string for c in want[2]]
        assert [c.string for c in high] == [c.string for c in want[3]]
        inplane = [d for d in range(3) if d != axis]
        plane = coverage.setdefault(
            (axis, split), np.zeros([shape[d] for d in inplane], int))
        plane[tuple(slice(int(node.bbox.start[d]), int(node.bbox.stop[d]))
                    for d in inplane)] += 1
        for side in (low, high):
            area = sum(np.prod([int(c.stop[d]) - int(c.start[d])
                                for d in inplane]) for c in side)
            assert area == np.prod([int(node.bbox.stop[d])
                                    - int(node.bbox.start[d])
                                    for d in inplane])
    internal = {(axis, int(c.stop[axis])) for axis in range(3)
                for c in plan.chunks if int(c.stop[axis]) < shape[axis]}
    assert set(coverage) == internal
    assert all((plane == 1).all() for plane in coverage.values())


def test_global_id_ranges_are_the_jax_packages():
    plan = SegmentPlan(BoundingBox((0, 0, 0), (13, 17, 9)), (5, 6, 4))
    jax_plan = JaxPlan(JaxBox((0, 0, 0), (13, 17, 9)), (5, 6, 4))
    offsets = [plan.id_offset(c) for c in plan.chunks]
    assert offsets == [jax_plan.id_offset(c) for c in jax_plan.chunks]
    assert plan.grid_shape == jax_plan.grid_shape
    assert plan.id_stride == jax_plan.id_stride == 5 * 6 * 4
    ordered = sorted(offsets)
    assert all(b - a >= plan.id_stride for a, b in zip(ordered,
                                                       ordered[1:]))


def test_task_bodies_round_trip():
    plan = SegmentPlan(BoundingBox((0, 0, 0), (12, 12, 12)), (6, 6, 6))
    jax_plan = JaxPlan(JaxBox((0, 0, 0), (12, 12, 12)), (6, 6, 6))
    chunk = plan.chunks[3]
    for body, kind, want in (
            (plan.label_body(chunk), "label",
             jax_plan.label_body(jax_plan.chunks[3])),
            (plan.merge_body(plan.bbox), "merge",
             jax_plan.merge_body(jax_plan.bbox)),
            (plan.relabel_body(chunk), "relabel",
             jax_plan.relabel_body(jax_plan.chunks[3]))):
        assert body == want
        parsed = SegmentPlan.parse_body(body)
        assert parsed[0] == kind == JaxPlan.parse_body(body)[0]
        assert parsed[1].string == JaxPlan.parse_body(body)[1].string
    assert SegmentPlan.parse_body(chunk.string) is None
    assert SegmentPlan.parse_body("unrelated") is None
    assert SegmentPlan.from_dict(plan.to_dict()).chunks == plan.chunks
    assert plan.to_dict() == jax_plan.to_dict()


def test_store_rejects_bad_connectivity():
    plan = SegmentPlan(BoundingBox((0, 0, 0), (8, 8, 8)), (4, 4, 4))
    with pytest.raises(ValueError, match="connectivity"):
        SegmentStore(plan, MemoryBackend(np.zeros((8, 8, 8), np.uint8)),
                     MemoryBackend(np.zeros((8, 8, 8), LABEL_DTYPE)),
                     MemoryKV(), connectivity=4)


def test_relabel_before_root_merge_raises():
    rng = np.random.default_rng(8)
    arr = (rng.random((8, 8, 8)) > 0.5).astype(np.uint8)
    store = _kv_store("port", arr, (0, 0, 0), (4, 4, 4))
    label_chunk(store, store.plan.chunks[0])
    with pytest.raises(RuntimeError, match="remap table"):
        relabel_chunk(store, store.plan.chunks[0])


# ---------------------------------------------------------------------------
# merge tables: tests/segment/test_merge_table.py's cases, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("values", [False, True])
def test_face_pair_edges_are_the_jax_packages(connectivity, values):
    rng = np.random.default_rng(connectivity + 7 * values)
    low = rng.integers(0, 9, (11, 13)).astype(np.uint64) << 33
    high = rng.integers(0, 9, (11, 13)).astype(np.uint64) << 33
    kw = {}
    if values:
        kw = {"low_values": rng.integers(0, 2, (11, 13)).astype(np.uint64),
              "high_values": rng.integers(0, 2, (11, 13)).astype(np.uint64)}
    got = mt.face_pair_edges(low, high, connectivity=connectivity, **kw)
    want = jax_mt.face_pair_edges(low, high, connectivity=connectivity, **kw)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want) and got.shape[0] > 0


def test_face_pair_edges_diagonal_only_at_26_and_errors():
    low = np.zeros((3, 3), np.uint64)
    high = np.zeros((3, 3), np.uint64)
    low[0, 0], high[1, 1] = 1, 2
    for c, n in ((6, 0), (18, 0), (26, 1)):
        assert mt.face_pair_edges(low, high, connectivity=c).shape[0] == n
    low[0, 0], high[0, 1] = 1, 3
    assert mt.face_pair_edges(low, high, connectivity=18).tolist() == [[1, 3]]
    with pytest.raises(ValueError, match="equal-shape"):
        mt.face_pair_edges(low, high[:2])
    with pytest.raises(ValueError, match="pair"):
        mt.face_pair_edges(low, high, low_values=low)
    with pytest.raises(ValueError, match="connectivity"):
        mt.face_pair_edges(low, high, connectivity=4)


def test_merge_table_is_the_jax_packages():
    rng = np.random.default_rng(3)
    sets = [rng.integers(1, 400, (n, 2)).astype(np.uint64) * 1000003
            for n in (50, 0, 120, 7)]
    got = mt.merge_table(sets)
    want = jax_mt.merge_table(sets)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    merged = mt.merge_edge_sets(sets)
    assert np.array_equal(merged, jax_mt.merge_edge_sets(sets))
    ids, roots = mt.union_find(merged)
    want_ids, want_roots = jax_mt.union_find(merged)
    assert np.array_equal(ids, want_ids) and np.array_equal(roots,
                                                            want_roots)
    # a fixpoint table: canonical ids are no keys
    assert not np.isin(got[:, 1], got[:, 0]).any()
    assert mt.merge_table([]).shape == (0, 2)
    labels = rng.choice(ids, (5, 6, 7))
    assert np.array_equal(mt.apply_mapping(labels, got[:, 0], got[:, 1]),
                          jax_mt.apply_mapping(labels, got[:, 0], got[:, 1]))


# ---------------------------------------------------------------------------
# the tree source: tests/parallel/test_tree_source.py's cases
# ---------------------------------------------------------------------------
def _trees(stop=(16, 8, 8), block=(4, 4, 4)):
    return (SpatialTaskTree(BoundingBox((0, 0, 0), stop), block),
            JaxTree(JaxBox((0, 0, 0), stop), block))


def _drain(queue):
    bodies = []
    while True:
        got = queue.receive()
        if got is None:
            return bodies
        handle, body = got
        bodies.append(body)
        queue.delete(handle)


def _source_pair(name, stop=(16, 8, 8), body=None):
    tree, jax_tree = _trees(stop)
    port = TreeTaskSource(tree, open_queue(f"memory://{name}"),
                          MemoryLedger(), body=body)
    jax = JaxSource(jax_tree, jax_queues.open_queue(f"memory://j-{name}"),
                    jax_lifecycle.MemoryLedger(), body=body)
    return port, jax


def test_tree_source_requires_a_ledger():
    with pytest.raises(ValueError, match="ledger"):
        TreeTaskSource(_trees()[0], open_queue("memory://ts-no"), None)


def test_first_sync_enqueues_the_leaves_in_preorder():
    port, jax = _source_pair("ts-leaves")
    assert port.sync() == jax.sync() == len(port.tree.leaf_list)
    got = _drain(port.queue)
    assert got == _drain(jax.queue)
    assert got == [n.bbox.string for n in port.tree.walk() if n.is_leaf]
    assert port.sync() == 0


def test_parent_unlocks_only_after_both_children_commit():
    port, _ = _source_pair("ts-unlock", stop=(8, 4, 4))
    tree = port.tree
    port.sync()
    assert _drain(port.queue) == [tree.left.bbox.string,
                                  tree.right.bbox.string]
    port.ledger.mark_done(tree.left.bbox.string)
    assert port.sync() == 0 and _drain(port.queue) == []
    port.ledger.mark_done(tree.right.bbox.string)
    assert port.sync() == 1
    assert _drain(port.queue) == [tree.bbox.string]
    port.ledger.mark_done(tree.bbox.string)
    port.sync()
    assert port.all_done and port.pending() == 0


@pytest.mark.parametrize("body", [None, lambda n: f"merge_{n.bbox.string}"],
                         ids=["bbox", "custom"])
def test_bodies_go_out_in_the_jax_order(body):
    """Both sources drained and committed round by round: the same
    bodies in the same rounds, every interior node after its children,
    the root last."""
    port, jax = _source_pair(f"ts-order-{body is None}", body=body)
    rounds = []
    while not port.all_done:
        assert port.sync() == jax.sync()
        got, want = _drain(port.queue), _drain(jax.queue)
        assert got == want
        rounds.append(got)
        for b in got:
            port.ledger.mark_done(b)
            jax.ledger.mark_done(b)
    assert jax.all_done
    flat = [b for r in rounds for b in r]
    assert len(flat) == sum(1 for _ in port.tree.walk())
    assert flat[-1] == (body or (lambda n: n.bbox.string))(port.tree)


def test_serialize_restore_mid_job_keeps_working_nodes_in_flight():
    port, _ = _source_pair("ts-serialize", stop=(8, 4, 4))
    tree = port.tree
    port.sync()
    port.ledger.mark_done(tree.left.bbox.string)
    restored = SpatialTaskTree.from_dict(tree.to_dict())
    resumed = TreeTaskSource(restored, port.queue, port.ledger)
    assert resumed.sync() == 0
    assert restored.left.is_done and not restored.right.is_done
    port.ledger.mark_done(tree.right.bbox.string)
    assert resumed.sync() == 1
    port.ledger.mark_done(tree.bbox.string)
    resumed.sync()
    assert resumed.all_done


def test_coordinator_crash_rebuild_from_plan_plus_ledger():
    port, _ = _source_pair("ts-rebuild")
    port.sync()
    bodies = _drain(port.queue)
    for body in bodies[: len(bodies) // 2]:
        port.ledger.mark_done(body)
    rebuilt = TreeTaskSource(_trees()[0], port.queue, port.ledger)
    rebuilt.sync()
    dup = _drain(port.queue)
    assert set(dup).isdisjoint(bodies[: len(bodies) // 2])
    assert set(bodies[len(bodies) // 2:]) <= set(dup)
    for body in dup:
        port.ledger.mark_done(body)
    while not rebuilt.all_done:
        if rebuilt.sync() == 0:
            break
        for body in _drain(port.queue):
            port.ledger.mark_done(body)
    assert rebuilt.all_done


def test_two_workers_with_the_tree_as_only_coordinator():
    tree = SpatialTaskTree(BoundingBox((0, 0, 0), (16, 16, 8)), (4, 4, 4))
    queue = open_queue("memory://ts-two-workers")
    ledger = open_ledger("memory://ts-two-workers-ledger")
    source = TreeTaskSource(tree, queue, ledger)
    stop = threading.Event()
    done = set()

    def worker():
        while not stop.is_set():
            got = queue.receive()
            if got is None:
                stop.wait(0.005)
                continue
            handle, body = got
            done.add(body)
            ledger.mark_done(body)
            queue.delete(handle)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        enqueued = source.run(poll_interval=0.005, timeout=30)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert source.all_done and enqueued == sum(1 for _ in tree.walk())
    assert done == {n.bbox.string for n in tree.walk()}
    assert queue.stats()["pending"] == queue.stats()["inflight"] == 0


def test_run_times_out_with_no_workers():
    source = TreeTaskSource(_trees(stop=(8, 8, 8))[0],
                            open_queue("memory://ts-timeout"),
                            MemoryLedger())
    with pytest.raises(TimeoutError, match="outstanding"):
        source.run(poll_interval=0.01, timeout=0.05)


# ---------------------------------------------------------------------------
# job directories, byte for byte
# ---------------------------------------------------------------------------
def _tree_bytes(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("multivalue", [False, True])
def test_job_directory_is_the_jax_packages(tmp_path, multivalue):
    """``run_local`` on the host leg in both packages from one input: the
    job directories (``spec.json``, the ``kv/`` sidecars and the label
    blocks) are equal file for file, byte for byte."""
    rng = np.random.default_rng(9 + multivalue)
    arr = (rng.integers(0, 3, (14, 12, 10)).astype(np.uint32) if multivalue
           else rng.random((14, 12, 10)).astype(np.float32))
    npy = str(tmp_path / "in.npy")
    np.save(npy, arr)
    kw = dict(threshold=0.6, connectivity=18, multivalue=multivalue)
    store = driver.init_store(str(tmp_path / "job"), npy, (6, 5, 4), **kw)
    run_local(store, workers=2)
    jax_store = jax_driver.init_store(str(tmp_path / "jax-job"), npy,
                                      (6, 5, 4), **kw)
    jax_driver.run_local(jax_store, workers=2)
    got = _tree_bytes(tmp_path / "job")
    assert got == _tree_bytes(tmp_path / "jax-job")
    assert "spec.json" in got and "kv/remap/table.npy" in got
    assert np.array_equal(export_segmentation(open_store(str(tmp_path /
                                                             "job"))),
                          jax_driver.export_segmentation(jax_store))


def test_a_port_worker_finishes_a_jax_job(tmp_path):
    """One package labels, the other merges and relabels from the same
    job directory: the volume is the one either package writes alone."""
    rng = np.random.default_rng(12)
    arr = rng.random((12, 12, 12)).astype(np.float32)
    npy = str(tmp_path / "in.npy")
    np.save(npy, arr)
    want = jax_driver.segment_volume(arr, (6, 6, 6), threshold=0.6)
    packages = {"jax": (jax_driver, jax_stages), "port": (driver, stages)}
    for first, second in (("jax", "port"), ("port", "jax")):
        job = str(tmp_path / f"job-{first}")
        drv, stg = packages[first]
        a = drv.init_store(job, npy, (6, 6, 6), threshold=0.6)
        for chunk in a.plan.chunks:
            stg.label_chunk(a, chunk)
        drv, stg = packages[second]
        b = drv.open_store(job)
        for node in b.plan.make_tree().post_order():
            if not node.is_leaf:
                stg.merge_node(b, node.bbox)
        for chunk in b.plan.chunks:
            stg.relabel_chunk(b, chunk)
        assert np.array_equal(drv.export_segmentation(b), want)


# ---------------------------------------------------------------------------
# the seven commands through both CLIs
# ---------------------------------------------------------------------------
def _jax_cli(args):
    result = CliRunner().invoke(jax_main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


@pytest.mark.parametrize("leg", [
    ["--host"], ["--device"], ["--multivalue"],
    ["--host", "--connectivity", "6", "-t", "0.4", "-w", "1"]],
    ids=["host", "device", "multivalue", "host-6"])
def test_segment_volume_through_both_clis(tmp_path, capsys, leg):
    rng = np.random.default_rng(4)
    arr = (rng.integers(0, 3, (14, 12, 10)).astype(np.uint32)
           if "--multivalue" in leg else
           rng.random((14, 12, 10)).astype(np.float32))
    npy = str(tmp_path / "in.npy")
    np.save(npy, arr)
    base = ["segment-volume", "-i", npy, "-c", "6", "5", "4", *leg,
            "--mesh-output"]
    assert cli.main(["--device", "cpu", *base, str(tmp_path / "mesh"),
                     "-d", str(tmp_path / "job")]) == 0
    _jax_cli([*base, str(tmp_path / "jax-mesh"), "-d",
              str(tmp_path / "jax-job")])
    assert "relabeled in place" in capsys.readouterr().out
    got = _tree_bytes(tmp_path / "job")
    want = _tree_bytes(tmp_path / "jax-job")
    spec, jax_spec = (json.loads(x.pop("spec.json")) for x in (got, want))
    assert spec.pop("mesh_dir") != jax_spec.pop("mesh_dir")
    assert spec == jax_spec
    assert got == want
    assert _tree_bytes(tmp_path / "mesh") == _tree_bytes(
        tmp_path / "jax-mesh")


def _worker_args(prefix, qdir, ledger, seg_dir, vis=3):
    return [*prefix, "fetch-task-from-queue", "-q", str(qdir), "-v",
            str(vis), "-r", "100", "--poll-interval", "0.05",
            "--max-retries", "3", "--ledger", str(ledger),
            "label-chunk", "-d", str(seg_dir),
            "merge-seg", "-d", str(seg_dir),
            "relabel", "-d", str(seg_dir),
            "delete-task-in-queue"]


PORT = [sys.executable, "-m", "chunkflow_tpu_torch", "--device", "cpu"]
JAX = [sys.executable, "-m", "chunkflow_tpu.flow.cli"]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    env.pop("XLA_FLAGS", None)
    env.pop("CHUNKFLOW_CHAOS", None)
    env.update(extra)
    return env


def _wait_for_spec(seg_dir, coordinator):
    deadline = time.monotonic() + 60
    while not (seg_dir / "spec.json").exists():
        assert coordinator.poll() is None, coordinator.communicate()[0]
        assert time.monotonic() < deadline
        time.sleep(0.05)


def _check_queue_job(tmp_path, arr, seg_dir, ledger, qdir):
    store = open_store(str(seg_dir))
    seg = export_segmentation(store)
    assert labels_isomorphic(seg, _monolithic(arr, 26))
    want = jax_driver.segment_volume(arr, store.plan.chunk_size)
    assert labels_isomorphic(seg, want)
    plan = store.plan
    expected = {plan.node_body(n) for n in plan.make_tree().walk()}
    expected |= {plan.relabel_body(c) for c in plan.chunks}
    assert sorted(FileLedger(str(ledger)).keys()) == sorted(expected)
    queue = open_queue(str(qdir))
    assert queue.stats()["pending"] == queue.stats()["inflight"] == 0
    assert queue.dead_letters() == []


def test_sigkill_mid_merge_replays_to_isomorphic_result(tmp_path):
    """The port's coordinator and two port workers: worker A kills itself
    inside its first merge (``segment/merge``: inputs read, table not
    written); worker B, started once A is dead (so A cannot miss the
    merges), drains the rest and A's merge once its lease expires."""
    rng = np.random.default_rng(11)
    arr = (rng.random((14, 12, 10)) > 0.6).astype(np.float32)
    npy = tmp_path / "input.npy"
    np.save(npy, arr)
    seg_dir, qdir, ledger = (tmp_path / "job", tmp_path / "queue",
                             tmp_path / "ledger")
    coordinator = subprocess.Popen(
        [*PORT, "segment-volume", "-i", str(npy), "-d", str(seg_dir), "-c",
         "6", "6", "6", "--connectivity", "26", "-q", str(qdir),
         "--ledger", str(ledger), "--timeout", "150"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    procs = [coordinator]
    try:
        _wait_for_spec(seg_dir, coordinator)
        proc_a = subprocess.Popen(
            _worker_args(PORT, qdir, ledger, seg_dir),
            env=_env(CHUNKFLOW_CHAOS="once=segment/merge:action=kill"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(proc_a)
        rc_a = proc_a.wait(timeout=120)
        assert rc_a in (-9, 137), (rc_a, proc_a.communicate()[0][-2000:])
        proc_b = subprocess.Popen(
            _worker_args(PORT, qdir, ledger, seg_dir), env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(proc_b)
        out, _ = coordinator.communicate(timeout=180)
        assert coordinator.returncode == 0, out[-3000:]
        assert "coordinated" in out
        assert proc_b.wait(timeout=60) == 0, proc_b.communicate()[0][-2000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    _check_queue_job(tmp_path, arr, seg_dir, ledger, qdir)


def test_a_jax_coordinator_is_drained_by_a_port_worker(tmp_path):
    rng = np.random.default_rng(13)
    arr = (rng.random((12, 12, 8)) > 0.6).astype(np.float32)
    npy = tmp_path / "input.npy"
    np.save(npy, arr)
    seg_dir, qdir, ledger = (tmp_path / "job", tmp_path / "queue",
                             tmp_path / "ledger")
    coordinator = subprocess.Popen(
        [*JAX, "segment-volume", "-i", str(npy), "-d", str(seg_dir), "-c",
         "6", "6", "4", "-q", str(qdir), "--ledger", str(ledger),
         "--timeout", "150"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    procs = [coordinator]
    try:
        _wait_for_spec(seg_dir, coordinator)
        worker = subprocess.Popen(
            _worker_args(PORT, qdir, ledger, seg_dir), env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(worker)
        out, _ = coordinator.communicate(timeout=180)
        assert coordinator.returncode == 0, out[-3000:]
        assert worker.wait(timeout=60) == 0, worker.communicate()[0][-2000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    _check_queue_job(tmp_path, arr, seg_dir, ledger, qdir)


def test_coordinator_mode_needs_a_ledger(tmp_path):
    np.save(tmp_path / "in.npy", np.zeros((4, 4, 4), np.float32))
    with pytest.raises(SystemExit, match="ledger"):
        cli.main(["--device", "cpu", "segment-volume", "-i",
                  str(tmp_path / "in.npy"), "-d", str(tmp_path / "job"),
                  "-c", "2", "2", "2", "-q", "memory://no-ledger"])


@pytest.mark.parametrize("leg", ["host", "device"])
def test_stage_commands_through_both_clis(tmp_path, capsys, leg):
    """``label-chunk``, ``merge-seg`` and ``relabel`` after
    ``fetch-task-from-queue``, wave by wave (the labels, each level of
    the merge tree, the relabels), through the port's CLI and the JAX
    CLI on copies of one job: the job directories end byte for byte
    equal."""
    rng = np.random.default_rng(14)
    npy = str(tmp_path / "in.npy")
    np.save(npy, rng.random((12, 12, 8)).astype(np.float32))
    jobs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    for job in jobs.values():
        driver.init_store(job, npy, (6, 6, 8), threshold=0.55,
                          device=leg == "device")
    plan = open_store(jobs["port"], device="cpu").plan
    tree = plan.make_tree()
    depth = {}
    for node in tree.post_order():
        depth[node.bbox.string] = (0 if node.is_leaf else 1 + max(
            depth[node.left.bbox.string], depth[node.right.bbox.string]))
    waves = [[plan.node_body(n) for n in tree.walk()
              if depth[n.bbox.string] == level]
             for level in range(max(depth.values()) + 1)]
    waves.append([plan.relabel_body(c) for c in plan.chunks])
    runs = {"port": lambda a: cli.main(["--device", "cpu", *a]) == 0,
            "jax": _jax_cli}
    for wave in waves:
        for tag, job in jobs.items():
            q = f"file://{tmp_path / f'q-{tag}'}"
            open_queue(q).send_messages(wave)
            runs[tag](["fetch-task-from-queue", "-q", q, "-r", "0",
                       "--poll-interval", "0.02", "--ledger",
                       str(tmp_path / f"ledger-{tag}"),
                       "label-chunk", "-d", job, "merge-seg", "-d", job,
                       "relabel", "-d", job, "delete-task-in-queue"])
    capsys.readouterr()
    got, want = _tree_bytes(jobs["port"]), _tree_bytes(jobs["jax"])
    assert "kv/remap/table.npy" in got and got == want
    seg = export_segmentation(open_store(jobs["port"], device="cpu"))
    assert np.array_equal(seg, jax_driver.segment_volume(
        np.load(npy), (6, 6, 8), threshold=0.55, device=leg == "device"))


def test_stage_commands_pass_other_traffic_through(tmp_path, capsys):
    """``label-chunk``, ``merge-seg`` and ``relabel`` leave a task that is
    not theirs as it is: a queue of plain bbox tasks goes through the
    chain untouched, in both CLIs."""
    np.save(tmp_path / "in.npy", np.zeros((4, 4, 4), np.float32))
    driver.init_store(str(tmp_path / "job"), str(tmp_path / "in.npy"),
                      (2, 2, 2))
    for tag, run in (("port", lambda a: cli.main(["--device", "cpu", *a])),
                     ("jax", _jax_cli)):
        q = f"file://{tmp_path / f'q-{tag}'}"
        chain = ["generate-tasks", "-s", "0", "0", "0", "-r", "4", "4",
                 "4", "-c", "2", "2", "2", "--queue-name", q]
        run(chain)
        run(["fetch-task-from-queue", "-q", q, "-r", "0", "--poll-interval",
             "0.02", "label-chunk", "-d", str(tmp_path / "job"),
             "merge-seg", "-d", str(tmp_path / "job"), "relabel", "-d",
             str(tmp_path / "job"), "delete-task-in-queue"])
        assert open_queue(q).stats()["pending"] == 0
    assert not os.path.exists(tmp_path / "job" / "kv")
    capsys.readouterr()


# ---------------------------------------------------------------------------
# no card, no device leg
# ---------------------------------------------------------------------------
@pytest.mark.skipif(HAS_CARD, reason="checks a box without a card")
def test_every_device_path_raises_without_a_card(tmp_path):
    arr = (np.random.default_rng(1).random((8, 8, 8)) > 0.5).astype(
        np.float32)
    for device in (True, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            segment_volume(arr, (4, 4, 4), device=device)
    npy = str(tmp_path / "in.npy")
    np.save(npy, arr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["segment-volume", "-i", npy, "-d", str(tmp_path / "a"),
                  "-c", "4", "4", "4", "--device"])
    # a job asking for the device leg, opened by a worker on its own
    # --device: the card unless the worker asks for the CPU
    driver.init_store(str(tmp_path / "b"), npy, (4, 4, 4), device="cpu")
    assert json.load(open(tmp_path / "b" / "spec.json"))["device"] is True
    store = open_store(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        label_chunk(store, store.plan.chunks[0])
    cpu = open_store(str(tmp_path / "b"), device="cpu")
    label_chunk(cpu, cpu.plan.chunks[0])
    # the host leg needs no card, whatever the group --device
    assert cli.main(["segment-volume", "-i", npy, "-d", str(tmp_path / "c"),
                     "-c", "4", "4", "4", "--host"]) == 0
