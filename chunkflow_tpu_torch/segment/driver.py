"""Drivers running the map -> reduce -> map as one job.

The port's copy of ``chunkflow_tpu/segment/driver.py``:

* :func:`run_local`: in process. The label and relabel phases fan out
  over a thread pool (chunk IO overlaps; the native labelling releases
  the interpreter lock), the reduce walks the tree in post-order.
* :func:`run_coordinator`: through a queue and a ledger. A
  :class:`parallel.tree_source.TreeTaskSource` pumps the label and merge
  tree, then the relabel wave goes out once the root committed. Workers
  are ``fetch-task-from-queue`` pipelines chaining ``label-chunk``,
  ``merge-seg`` and ``relabel``; the coordinator runs no task and derives
  all it does from the plan and the ledger, so it can die and resume.

:func:`init_store` writes a job directory's ``spec.json`` (the JAX
package's keys; ``"device"`` a bool) and :func:`open_store` rebuilds the
store from it in any process: the labels in a ``KVArrayBackend`` under
``kv/seg``, the sidecars beside them, byte for byte the JAX package's
layout. A job whose spec asks for the device leg labels on the opening
process's ``device`` (the card unless it asks for the CPU).
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.segment.plan import SegmentPlan
from chunkflow_tpu_torch.segment.stages import (
    LABEL_DTYPE,
    SegmentStore,
    device_name,
    label_chunk,
    merge_node,
    relabel_chunk,
)
from chunkflow_tpu_torch.volume.storage import (
    FileKV,
    KVArrayBackend,
    MemoryBackend,
    MemoryKV,
    blockwise_cutout,
)

SPEC_NAME = "spec.json"


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------
def _map_phase(fn, store: SegmentStore, bboxes, workers: int) -> None:
    if workers <= 1:
        for bbox in bboxes:
            fn(store, bbox)
        return
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="chunkflow-segment") as pool:
        futures = [pool.submit(fn, store, bbox) for bbox in bboxes]
        for future in futures:
            future.result()


def run_local(store: SegmentStore, workers: int = 4) -> dict:
    """The whole job in this process; returns phase counts."""
    plan = store.plan
    _map_phase(label_chunk, store, plan.chunks, workers)
    merges = 0
    for node in plan.make_tree().post_order():
        if not node.is_leaf:
            merge_node(store, node.bbox)
            merges += 1
    _map_phase(relabel_chunk, store, plan.chunks, workers)
    return {"chunks": len(plan.chunks), "merge_nodes": merges}


def segment_volume(array: np.ndarray, chunk_size, *, threshold: float = 0.5,
                   connectivity: int = 26, multivalue: bool = False,
                   device=False, workers: int = 4,
                   mesh_dir: Optional[str] = None) -> np.ndarray:
    """Stitch-label a host array through an in-memory store; returns the
    merged uint64 segmentation. ``device``: falsy for the host leg, else
    the device leg on the card (``True``) or the device named."""
    bbox = BoundingBox((0, 0, 0), tuple(int(s) for s in array.shape))
    plan = SegmentPlan(bbox, chunk_size)
    seg_array = np.zeros(array.shape, dtype=LABEL_DTYPE)
    store = SegmentStore(
        plan,
        input_backend=MemoryBackend(array, block_shape=plan.chunk_size),
        seg_backend=MemoryBackend(seg_array, block_shape=plan.chunk_size),
        kv=MemoryKV(), threshold=threshold, connectivity=connectivity,
        multivalue=multivalue, device=device, mesh_dir=mesh_dir)
    run_local(store, workers=workers)
    return seg_array


# ---------------------------------------------------------------------------
# the job directory
# ---------------------------------------------------------------------------
def init_store(seg_dir: str, input_npy: str, chunk_size, *,
               threshold: float = 0.5, connectivity: int = 26,
               multivalue: bool = False, device=False,
               mesh_dir: Optional[str] = None) -> SegmentStore:
    """Write a job directory's ``spec.json`` and open its store.
    ``input_npy`` stays a path: workers map it read-only. ``device`` as
    :func:`segment_volume`'s; the spec keeps whether it was asked."""
    os.makedirs(seg_dir, exist_ok=True)
    shape = np.load(input_npy, mmap_mode="r").shape
    if len(shape) != 3:
        raise ValueError(f"segmentation input must be 3D, got {shape}")
    spec = {
        "bbox": BoundingBox((0, 0, 0), tuple(int(s) for s in shape)).string,
        "chunk_size": [int(v) for v in chunk_size],
        "input_npy": os.path.abspath(input_npy),
        "threshold": float(threshold),
        "connectivity": int(connectivity),
        "multivalue": bool(multivalue),
        "device": device_name(device) is not None,
        "mesh_dir": mesh_dir,
    }
    path = os.path.join(seg_dir, SPEC_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
    os.replace(tmp, path)
    return open_store(seg_dir, device=device_name(device) or "cuda")


def open_store(seg_dir: str, device="cuda") -> SegmentStore:
    """The store of a job directory, rebuilt from its ``spec.json`` (each
    worker process does this once). A spec with ``"device": true``
    labels on ``device``."""
    with open(os.path.join(seg_dir, SPEC_NAME)) as f:
        spec = json.load(f)
    plan = SegmentPlan(BoundingBox.from_string(spec["bbox"]),
                       spec["chunk_size"])
    source = np.load(spec["input_npy"], mmap_mode="r")
    kv = FileKV(os.path.join(seg_dir, "kv"))
    seg_backend = KVArrayBackend(kv, domain=(plan.bbox.start, plan.bbox.stop),
                                 dtype=LABEL_DTYPE,
                                 block_shape=plan.chunk_size, prefix="seg")
    return SegmentStore(
        plan, input_backend=MemoryBackend(source, block_shape=plan.chunk_size),
        seg_backend=seg_backend, kv=kv, threshold=spec["threshold"],
        connectivity=spec["connectivity"], multivalue=spec["multivalue"],
        device=device if spec.get("device", False) else False,
        mesh_dir=spec.get("mesh_dir"))


def export_segmentation(store: SegmentStore) -> np.ndarray:
    """The whole (relabelled) segmentation."""
    return blockwise_cutout(store.seg_backend, store.plan.bbox.start,
                            store.plan.bbox.stop)


# ---------------------------------------------------------------------------
# through a queue
# ---------------------------------------------------------------------------
def run_coordinator(store: SegmentStore, queue, ledger, *,
                    poll_interval: float = 0.05,
                    timeout: Optional[float] = None) -> dict:
    """Drive the job through a queue and a ledger: the label and merge
    tree through :class:`TreeTaskSource`, then the relabel wave once the
    root committed. A restarted coordinator folds the ledger (committed
    nodes are done; duplicate messages end in ledger skips)."""
    from chunkflow_tpu_torch.parallel.tree_source import TreeTaskSource

    plan = store.plan
    deadline = None if timeout is None else time.monotonic() + timeout
    source = TreeTaskSource(plan.make_tree(), queue, ledger,
                            body=plan.node_body)
    source.run(poll_interval=poll_interval,
               timeout=None if deadline is None
               else deadline - time.monotonic())
    relabel_bodies: List[str] = [plan.relabel_body(chunk)
                                 for chunk in plan.chunks]
    outstanding = [body for body in relabel_bodies
                   if not ledger.is_done(body)]
    if outstanding:
        queue.send_messages(outstanding)
    while any(not ledger.is_done(body) for body in relabel_bodies):
        if deadline is not None and time.monotonic() > deadline:
            left = sum(1 for b in relabel_bodies if not ledger.is_done(b))
            raise TimeoutError(f"relabel wave incomplete: {left} chunks "
                               f"outstanding")
        time.sleep(poll_interval)
    return {"tree_tasks": source.enqueued,
            "relabel_tasks": len(outstanding)}
