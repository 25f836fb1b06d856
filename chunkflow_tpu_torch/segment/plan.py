"""Geometry of one stitching job: grid, global-id scheme, task bodies.

The port's copy of ``chunkflow_tpu/segment/plan.py``. The plan is pure
arithmetic over (roi bbox, chunk size): every worker and the coordinator
rebuild the same plan from the job spec.

* **Grid**: the roi splits into chunks of ``chunk_size`` anchored at
  ``bbox.start``; trailing chunks clamp at ``bbox.stop``. The grid is the
  leaf set of ``SpatialTaskTree(bbox, chunk_size)``, which splits on
  block boundaries, so every internal grid interface is the split plane
  of exactly one interior node.
* **Global ids**: chunk ``i`` (raster linear index) owns
  ``(i * stride, (i + 1) * stride]`` with ``stride = prod(chunk_size)``,
  a bound on a chunk's label count for the host (consecutive) and the
  device (linear-index seeds) legs alike.
* **Task bodies**: ``seg-label_<bbox>``, ``seg-merge_<bbox>``,
  ``seg-relabel_<bbox>``: plain queue bodies (``BoundingBox.from_string``
  reads the last three ``a-b`` groups), so ``fetch-task-from-queue``
  carries them and the ledger keys them as they are.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import to_cartesian
from chunkflow_tpu_torch.parallel.task_tree import SpatialTaskTree

LABEL_PREFIX = "seg-label_"
MERGE_PREFIX = "seg-merge_"
RELABEL_PREFIX = "seg-relabel_"

AXIS_NAMES = "zyx"

REMAP_KEY = "remap/table.npy"


def face_key(chunk_bbox: BoundingBox, axis: int, positive: bool) -> str:
    """KV key of one boundary face of one chunk's labels."""
    sign = "+" if positive else "-"
    return f"face/{chunk_bbox.string}/{AXIS_NAMES[axis]}{sign}.npy"


def value_face_key(chunk_bbox: BoundingBox, axis: int,
                   positive: bool) -> str:
    """KV key of one boundary face of the input values (multi-value mode
    only: a cross-face merge also needs equal input ids)."""
    sign = "+" if positive else "-"
    return f"face/{chunk_bbox.string}/{AXIS_NAMES[axis]}{sign}.val.npy"


def merge_key(node_bbox: BoundingBox) -> str:
    """KV key of one interior node's merge table."""
    return f"merge/{node_bbox.string}.npy"


class SegmentPlan:
    """The grid, id space and task bodies of one job."""

    def __init__(self, bbox: BoundingBox, chunk_size):
        self.bbox = bbox
        self.chunk_size = tuple(int(v) for v in to_cartesian(chunk_size))
        if any(s <= 0 for s in self.chunk_size):
            raise ValueError(f"bad chunk size {self.chunk_size}")
        shape = tuple(int(s) for s in bbox.shape)
        self.grid_shape = tuple(-(-shape[d] // self.chunk_size[d])
                                for d in range(3))
        #: the per-chunk global-id stride (module docstring)
        self.id_stride = 1
        for s in self.chunk_size:
            self.id_stride *= int(s)
        self.chunks: List[BoundingBox] = []
        self._chunk_index: Dict[str, Tuple[int, int, int]] = {}
        for idx in itertools.product(*(range(g) for g in self.grid_shape)):
            lo = tuple(int(bbox.start[d]) + idx[d] * self.chunk_size[d]
                       for d in range(3))
            hi = tuple(min(lo[d] + self.chunk_size[d], int(bbox.stop[d]))
                       for d in range(3))
            chunk = BoundingBox(lo, hi)
            self.chunks.append(chunk)
            self._chunk_index[chunk.string] = idx
        # answers structural queries only; schedulers take make_tree()
        self._template = SpatialTaskTree(bbox, self.chunk_size)
        self._nodes: Dict[str, SpatialTaskTree] = {
            node.bbox.string: node for node in self._template.walk()}

    # ---- grid ----------------------------------------------------------
    def grid_index(self, chunk_bbox: BoundingBox) -> Tuple[int, int, int]:
        try:
            return self._chunk_index[chunk_bbox.string]
        except KeyError:
            raise ValueError(f"{chunk_bbox.string} is not a grid chunk of "
                             f"this plan") from None

    def linear_index(self, chunk_bbox: BoundingBox) -> int:
        iz, iy, ix = self.grid_index(chunk_bbox)
        _, gy, gx = self.grid_shape
        return (iz * gy + iy) * gx + ix

    def id_offset(self, chunk_bbox: BoundingBox) -> int:
        """The base of the chunk's global ids (local 1..n become
        ``offset + 1 .. offset + n``)."""
        return self.linear_index(chunk_bbox) * self.id_stride

    # ---- tree ----------------------------------------------------------
    def make_tree(self) -> SpatialTaskTree:
        """A fresh (all ready) scheduling tree of this job."""
        return SpatialTaskTree(self.bbox, self.chunk_size)

    def node(self, bbox: BoundingBox) -> SpatialTaskTree:
        """The template node at ``bbox``."""
        try:
            return self._nodes[bbox.string]
        except KeyError:
            raise ValueError(f"{bbox.string} is not a tree node of this "
                             f"plan") from None

    def split_axis(self, node: SpatialTaskTree) -> int:
        """The axis an interior node's interface plane is normal to."""
        if node.is_leaf:
            raise ValueError("leaves have no split plane")
        for axis in range(3):
            if int(node.left.bbox.stop[axis]) != int(node.bbox.stop[axis]):
                return axis
        raise AssertionError("degenerate split")  # pragma: no cover

    def plane_chunks(self, node: SpatialTaskTree
                     ) -> Tuple[int, int, List[BoundingBox],
                                List[BoundingBox]]:
        """One interior node's interface: ``(axis, coordinate,
        low_chunks, high_chunks)``, the grid chunks whose ``+axis``
        (``-axis``) faces tile the node's split plane."""
        axis = self.split_axis(node)
        split = int(node.left.bbox.stop[axis])

        def inside(c: BoundingBox) -> bool:
            return all(int(node.bbox.start[d]) <= int(c.start[d])
                       and int(c.stop[d]) <= int(node.bbox.stop[d])
                       for d in range(3))

        low = [c for c in self.chunks
               if int(c.stop[axis]) == split and inside(c)]
        high = [c for c in self.chunks
                if int(c.start[axis]) == split and inside(c)]
        return axis, split, low, high

    # ---- task bodies ---------------------------------------------------
    def label_body(self, chunk_bbox: BoundingBox) -> str:
        return LABEL_PREFIX + chunk_bbox.string

    def merge_body(self, node_bbox: BoundingBox) -> str:
        return MERGE_PREFIX + node_bbox.string

    def relabel_body(self, chunk_bbox: BoundingBox) -> str:
        return RELABEL_PREFIX + chunk_bbox.string

    def node_body(self, node: SpatialTaskTree) -> str:
        """A tree node's queue body (and ledger key): leaves label,
        interior nodes merge."""
        if node.is_leaf:
            return self.label_body(node.bbox)
        return self.merge_body(node.bbox)

    @staticmethod
    def parse_body(body: str) -> Optional[Tuple[str, BoundingBox]]:
        """``(kind, bbox)`` of a segmentation task body; None for other
        queue traffic (the stages pass it through)."""
        for kind, prefix in (("label", LABEL_PREFIX),
                             ("merge", MERGE_PREFIX),
                             ("relabel", RELABEL_PREFIX)):
            if body.startswith(prefix):
                return kind, BoundingBox.from_string(body[len(prefix):])
        return None

    # ---- spec ----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"bbox": self.bbox.string,
                "chunk_size": list(self.chunk_size)}

    @classmethod
    def from_dict(cls, data: dict) -> "SegmentPlan":
        return cls(BoundingBox.from_string(data["bbox"]), data["chunk_size"])
