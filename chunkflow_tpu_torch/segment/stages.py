"""The three task stages of the stitching job, over one
:class:`SegmentStore`.

The port's copy of ``chunkflow_tpu/segment/stages.py``. Every stage is
idempotent, so a replay after a SIGKILL mid-task rewrites what it wrote:

* ``label_chunk`` writes a pure function of (input chunk, plan).
* ``merge_node`` writes a pure function of its children's tables and the
  face sidecars, all written before the children committed. The
  ``segment/merge`` chaos point sits after the reads and before the
  write (``CHUNKFLOW_CHAOS=once=segment/merge:action=kill``).
* ``relabel_chunk`` applies a fixpoint table (canonical ids map to
  themselves), which leaves relabelled data as it is.

Labels are ``np.uint64`` on the host throughout. The one device leg is
``_label_local`` under ``device``: it uploads a chunk's mask, labels it
by propagation on the store's ``device_name`` (the card unless asked
for the CPU) and reads the uint32 labels back once; they are lifted into
the global ids on the host.

Telemetry: counters ``segment/chunks_labeled``, ``segment/faces_written``,
``segment/faces_exchanged``, ``segment/edges_found``,
``segment/merges_applied``, ``segment/voxels_relabeled`` (the JAX
package's), and spans ``segment/label``, ``segment/merge``,
``segment/relabel`` around each stage (the port's).
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.segment import merge_table as mt
from chunkflow_tpu_torch.segment.plan import (
    REMAP_KEY,
    SegmentPlan,
    face_key,
    merge_key,
    value_face_key,
)
from chunkflow_tpu_torch.testing import chaos
from chunkflow_tpu_torch.volume.storage import (
    KVBackend,
    StorageBackend,
    blockwise_cutout,
    blockwise_save,
)

LABEL_DTYPE = np.uint64


def _to_npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _from_npy_bytes(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def device_name(device) -> Optional[str]:
    """The torch device of a ``device`` knob: falsy for the host leg,
    ``True`` for the card, else the device named."""
    if device is False or device is None:
        return None
    return "cuda" if device is True else str(device)


class SegmentStore:
    """One stitching job's state: the plan, the backends and the
    labelling knobs. ``input_backend`` holds the source (probability map,
    binary mask or multi-valued ids), ``seg_backend`` the uint64 labels
    (its block grid is the chunk grid, so chunk writes never overlap),
    ``kv`` the sidecars (faces, merge tables, the remap table).
    ``device``: the host leg when falsy, else the device leg on the card
    (``True``) or on the device named."""

    def __init__(self, plan: SegmentPlan, input_backend: StorageBackend,
                 seg_backend: StorageBackend, kv: KVBackend, *,
                 threshold: float = 0.5, connectivity: int = 26,
                 multivalue: bool = False, device=False,
                 mesh_dir: Optional[str] = None, voxel_size=(1, 1, 1)):
        if connectivity not in (6, 18, 26):
            raise ValueError(f"connectivity must be 6, 18 or 26, got "
                             f"{connectivity}")
        self.plan = plan
        self.input_backend = input_backend
        self.seg_backend = seg_backend
        self.kv = kv
        self.threshold = float(threshold)
        self.connectivity = int(connectivity)
        self.multivalue = bool(multivalue)
        self.device_name = device_name(device)
        self.device = self.device_name is not None
        self.mesh_dir = mesh_dir
        self.voxel_size = tuple(voxel_size)
        self._remap_cache: Optional[tuple] = None

    # ---- sidecars ------------------------------------------------------
    def write_array(self, key: str, arr: np.ndarray) -> None:
        self.kv.write_bytes(key, _to_npy_bytes(arr))

    def read_array(self, key: str) -> Optional[np.ndarray]:
        data = self.kv.read_bytes(key)
        return None if data is None else _from_npy_bytes(data)

    def remap_table(self) -> tuple:
        """The root's (keys, values) remap table, read once per process:
        it is written once, before any relabel task exists."""
        if self._remap_cache is None:
            table = self.read_array(REMAP_KEY)
            if table is None:
                if len(self.plan.chunks) == 1:
                    # a one-chunk grid has no interface and no merge
                    table = np.empty((0, 2), dtype=LABEL_DTYPE)
                else:
                    raise RuntimeError("remap table not written yet: the "
                                       "root merge must commit before "
                                       "relabel tasks run")
            self._remap_cache = (table[:, 0], table[:, 1])
        return self._remap_cache


# ---------------------------------------------------------------------------
# map 1: per-chunk labelling
# ---------------------------------------------------------------------------
def _label_local(store: SegmentStore, src: np.ndarray) -> np.ndarray:
    """One chunk's local labels: the host union-find, or the device
    propagation for a binary (thresholded) input."""
    from chunkflow_tpu_torch.ops import connected_components as cc

    if store.multivalue:
        return cc.label_multivalue(src, connectivity=store.connectivity)
    if np.dtype(src.dtype).kind == "f":
        binary = src > store.threshold
    else:
        binary = src != 0
    if store.device:
        return cc.label_binary_device(
            binary, connectivity=store.connectivity,
            device=store.device_name).cpu().numpy()
    return cc.label_binary(binary, connectivity=store.connectivity)


def label_chunk(store: SegmentStore, bbox: BoundingBox) -> int:
    """Label one grid chunk, lift it into the global ids, save it
    blockwise and its boundary faces as sidecars. Returns the number of
    local labels."""
    with telemetry.span("segment/label"):
        plan = store.plan
        offset = plan.id_offset(bbox)
        src = blockwise_cutout(store.input_backend, bbox.start, bbox.stop)
        local = _label_local(store, src)
        labels = local.astype(LABEL_DTYPE)
        nonzero = labels != 0
        labels[nonzero] += LABEL_DTYPE(offset)
        blockwise_save(store.seg_backend, bbox.start, labels)
        faces = 0
        for axis in range(3):
            for positive in (False, True):
                edge = (int(bbox.stop[axis]) < int(plan.bbox.stop[axis])
                        if positive else
                        int(bbox.start[axis]) > int(plan.bbox.start[axis]))
                if not edge:
                    continue  # the roi's boundary: nothing beyond
                sel = [slice(None)] * 3
                sel[axis] = -1 if positive else 0
                store.write_array(face_key(bbox, axis, positive),
                                  labels[tuple(sel)])
                if store.multivalue:
                    # touching objects of different input ids stay apart
                    store.write_array(value_face_key(bbox, axis, positive),
                                      src[tuple(sel)].astype(LABEL_DTYPE))
                faces += 1
        count = int(np.unique(local).size - (1 if nonzero.any() else 0))
    telemetry.inc("segment/chunks_labeled")
    if faces:
        telemetry.inc("segment/faces_written", faces)
    return count


# ---------------------------------------------------------------------------
# reduce: the merge tree
# ---------------------------------------------------------------------------
def _interface_planes(store: SegmentStore, node) -> tuple:
    """The two FULL label planes of an interior node's split interface,
    assembled from the chunks' face sidecars (the low side's ``+``, the
    high side's ``-`` faces), so contacts across grid edges and corners
    are seen (``merge_table.face_pair_edges``)."""
    plan = store.plan
    axis, _split, low_chunks, high_chunks = plan.plane_chunks(node)
    inplane = [d for d in range(3) if d != axis]
    shape = tuple(int(node.bbox.stop[d]) - int(node.bbox.start[d])
                  for d in inplane)
    planes = []
    value_planes = []
    exchanged = 0
    for side_chunks, positive in ((low_chunks, True), (high_chunks, False)):
        plane = np.zeros(shape, dtype=LABEL_DTYPE)
        values = (np.zeros(shape, dtype=LABEL_DTYPE) if store.multivalue
                  else None)
        for chunk in side_chunks:
            strip = store.read_array(face_key(chunk, axis, positive))
            if strip is None:  # pragma: no cover - a scheduling fault
                raise RuntimeError(f"missing face sidecar "
                                   f"{face_key(chunk, axis, positive)}")
            anchor = tuple(int(chunk.start[d]) - int(node.bbox.start[d])
                           for d in inplane)
            window = (slice(anchor[0], anchor[0] + strip.shape[0]),
                      slice(anchor[1], anchor[1] + strip.shape[1]))
            plane[window] = strip
            if values is not None:
                vstrip = store.read_array(
                    value_face_key(chunk, axis, positive))
                if vstrip is None:  # pragma: no cover
                    raise RuntimeError(
                        "missing value face sidecar "
                        f"{value_face_key(chunk, axis, positive)}")
                values[window] = vstrip
            exchanged += 1
        planes.append(plane)
        value_planes.append(values)
    telemetry.inc("segment/faces_exchanged", exchanged)
    return planes[0], planes[1], value_planes[0], value_planes[1]


def merge_node(store: SegmentStore, bbox: BoundingBox) -> int:
    """One interior node's merge: its interface edges with both
    children's tables through union-find; the root also writes the
    global remap table. Returns the rows of the node's table."""
    with telemetry.span("segment/merge"):
        plan = store.plan
        node = plan.node(bbox)
        low, high, low_values, high_values = _interface_planes(store, node)
        edges = mt.face_pair_edges(low, high,
                                   connectivity=store.connectivity,
                                   low_values=low_values,
                                   high_values=high_values)
        telemetry.inc("segment/edges_found", int(edges.shape[0]))
        edge_sets = [edges]
        for child in (node.left, node.right):
            if child.is_leaf:
                continue
            table = store.read_array(merge_key(child.bbox))
            if table is None:  # pragma: no cover - a scheduling fault
                raise RuntimeError(f"missing child merge table "
                                   f"{merge_key(child.bbox)}")
            edge_sets.append(table)
        # inputs read, output not written: a kill here replays to the
        # same bytes
        chaos.chaos_point("segment/merge")
        table = mt.merge_table(edge_sets)
        store.write_array(merge_key(bbox), table)
        if node.parent is None:  # the root's table is the global remap
            store.write_array(REMAP_KEY, table)
            telemetry.inc("segment/merges_applied", int(table.shape[0]))
    return int(table.shape[0])


# ---------------------------------------------------------------------------
# map 2: relabel (and mesh)
# ---------------------------------------------------------------------------
def relabel_chunk(store: SegmentStore, bbox: BoundingBox) -> int:
    """Apply the root remap to one chunk in place, then mesh it when the
    store has a mesh directory. Returns the voxels whose id changed."""
    from chunkflow_tpu_torch.ops.remap import remap_arrays

    with telemetry.span("segment/relabel"):
        keys, values = store.remap_table()
        labels = blockwise_cutout(store.seg_backend, bbox.start, bbox.stop)
        merged = remap_arrays(labels, keys, values, preserve_missing=True)
        changed = int((merged != labels).sum())
        if changed:
            blockwise_save(store.seg_backend, bbox.start, merged)
    telemetry.inc("segment/voxels_relabeled", changed)
    if store.mesh_dir is not None:
        _mesh_chunk(store, bbox, merged)
    return changed


def _mesh_chunk(store: SegmentStore, bbox: BoundingBox,
                merged: np.ndarray) -> None:
    """Mesh one relabelled chunk: fragments carry the merged global ids,
    so an object's fragments from several chunks share one manifest."""
    from chunkflow_tpu_torch.chunk.base import Chunk, LayerType
    from chunkflow_tpu_torch.flow.mesh import MeshOperator

    seg = Chunk(merged, voxel_offset=tuple(int(v) for v in bbox.start),
                voxel_size=store.voxel_size,
                layer_type=LayerType.SEGMENTATION)
    MeshOperator(store.mesh_dir, manifest=True)(seg)


# ---------------------------------------------------------------------------
# body dispatch (the CLI stages and the local driver)
# ---------------------------------------------------------------------------
_STAGES = {"label": label_chunk, "merge": merge_node,
           "relabel": relabel_chunk}


def execute_body(store: SegmentStore, body: str) -> bool:
    """Run the stage a queue body names; False for other traffic (the
    caller passes the task through)."""
    parsed = SegmentPlan.parse_body(body)
    if parsed is None:
        return False
    kind, bbox = parsed
    _STAGES[kind](store, bbox)
    return True
