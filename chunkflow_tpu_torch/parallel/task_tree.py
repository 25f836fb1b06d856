"""Spatial task dependency tree and global id allocation.

The counterpart of ``chunkflow_tpu/parallel/task_tree.py`` (numpy
only), kept here so the port imports nothing of the JAX package:
``SpatialTaskTree``, a binary spatial decomposition of a box into block
tasks with ready / working / done states and bottom-up completion, and
``GlobalIdAllocator``, which hands out disjoint global id ranges. The
coordination service (``parallel/restapi.py``) serves both over HTTP.
"""
from __future__ import annotations

import json
import threading
from typing import Iterator, List, Optional

import numpy as np

from chunkflow_tpu_torch.core.bbox import BoundingBox
from chunkflow_tpu_torch.core.cartesian import to_cartesian

READY = "ready"
WORKING = "working on"
DONE = "done"


class SpatialTaskTree:
    """Binary spatial decomposition with bottom-up completion states.

    Leaves are atomic block tasks; an interior node becomes ``done`` only
    when both children are (its own merge step can then run). All state
    transitions are thread-safe so one tree can back a multi-worker
    scheduler.
    """

    def __init__(
        self,
        bbox: BoundingBox,
        block_size,
        parent: Optional["SpatialTaskTree"] = None,
        _lock: Optional[threading.RLock] = None,
    ):
        self.bbox = bbox
        self.block_size = tuple(to_cartesian(block_size))
        self.parent = parent
        self.state = READY
        self.left: Optional[SpatialTaskTree] = None
        self.right: Optional[SpatialTaskTree] = None
        self._lock = _lock if _lock is not None else threading.RLock()

        shape = bbox.shape
        blocks = [
            -(-int(shape[i]) // int(self.block_size[i])) for i in range(3)
        ]
        if max(blocks) <= 1:
            return  # leaf
        axis = int(np.argmax(blocks))
        left_blocks = blocks[axis] // 2
        split = int(bbox.start[axis]) + left_blocks * int(self.block_size[axis])

        left_stop = list(bbox.stop)
        left_stop[axis] = split
        self.left = SpatialTaskTree(
            BoundingBox(bbox.start, tuple(left_stop)),
            self.block_size, parent=self, _lock=self._lock,
        )
        right_start = list(bbox.start)
        right_start[axis] = split
        self.right = SpatialTaskTree(
            BoundingBox(tuple(right_start), bbox.stop),
            self.block_size, parent=self, _lock=self._lock,
        )

    # ---- structure -----------------------------------------------------
    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    @property
    def leaf_list(self) -> List["SpatialTaskTree"]:
        if self.is_leaf:
            return [self]
        return self.left.leaf_list + self.right.leaf_list

    def walk(self) -> Iterator["SpatialTaskTree"]:
        yield self
        if not self.is_leaf:
            yield from self.left.walk()
            yield from self.right.walk()

    def post_order(self) -> Iterator["SpatialTaskTree"]:
        """Children-before-parents traversal — the execution order of a
        serial hierarchical merge."""
        if not self.is_leaf:
            yield from self.left.post_order()
            yield from self.right.post_order()
        yield self

    def find(self, bbox_string: str) -> Optional["SpatialTaskTree"]:
        """The node whose bbox renders as ``bbox_string`` (task bodies
        round-trip through bbox strings), or None."""
        for node in self.walk():
            if node.bbox.string == bbox_string:
                return node
        return None

    # ---- state machine -------------------------------------------------
    @property
    def is_done(self) -> bool:
        return self.state == DONE

    def set_state_working_on(self) -> None:
        with self._lock:
            self.state = WORKING

    def set_state_done(self, auto_propagate: bool = False) -> None:
        """Mark done. With ``auto_propagate`` (the reference's semantics,
        task.py:133-140), a parent whose children are both done becomes done
        itself — for trees whose interior nodes carry no merge work. Without
        it, interior nodes become *claimable* via next_ready_task once their
        children finish (hierarchical merge scheduling)."""
        with self._lock:
            self.state = DONE
            if (
                auto_propagate
                and self.parent is not None
                and self.parent.left.is_done
                and self.parent.right.is_done
            ):
                self.parent.set_state_done(auto_propagate=True)

    def next_ready_task(self) -> Optional["SpatialTaskTree"]:
        """Claim the next runnable node: a ready leaf, or a ready interior
        node whose children are both done (its merge step). Returns None
        when nothing is runnable right now."""
        with self._lock:
            for node in self.walk():
                if node.state != READY:
                    continue
                if node.is_leaf or (node.left.is_done and node.right.is_done):
                    node.set_state_working_on()
                    return node
            return None

    @property
    def all_done(self) -> bool:
        return all(node.is_done for node in self.walk())

    # ---- serialization -------------------------------------------------
    @property
    def json(self) -> str:
        return json.dumps(self.to_dict())

    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "bbox": self.bbox.string,
            "block_size": list(self.block_size),
            "left": None if self.left is None else self.left.to_dict(),
            "right": None if self.right is None else self.right.to_dict(),
        }

    @classmethod
    def from_dict(
        cls, data: dict, parent: Optional["SpatialTaskTree"] = None
    ) -> "SpatialTaskTree":
        tree = cls.__new__(cls)
        tree.bbox = BoundingBox.from_string(data["bbox"])
        tree.block_size = tuple(data["block_size"])
        tree.state = data["state"]
        tree.parent = parent
        tree._lock = parent._lock if parent is not None else threading.RLock()
        tree.left = (
            cls.from_dict(data["left"], parent=tree) if data["left"] else None
        )
        tree.right = (
            cls.from_dict(data["right"], parent=tree) if data["right"] else None
        )
        return tree

    @classmethod
    def from_json(cls, text: str) -> "SpatialTaskTree":
        return cls.from_dict(json.loads(text))


class GlobalIdAllocator:
    """Hand out disjoint global segment-ID ranges (reference server.py:12-23,
    made thread-safe)."""

    def __init__(self, start_id: int = 0):
        self._next = int(start_id)
        self._lock = threading.Lock()

    def allocate(self, count: int) -> int:
        """Reserve ``count`` ids; returns the base id of the range."""
        assert count >= 0
        with self._lock:
            base = self._next
            self._next += int(count)
            return base

    @property
    def watermark(self) -> int:
        return self._next
