"""TreeTaskSource: a SpatialTaskTree feeding the ordinary queue loop.

The port's copy of ``chunkflow_tpu/parallel/tree_source.py``. A flat
queue cannot say "the parent merge waits for both children", and the
supervised worker loop (``fetch-task-from-queue``,
``parallel/lifecycle.py``) need not learn it: this source keeps the
dependencies on the submitting side.

* The tree's ready frontier goes out as ordinary queue bodies: leaves
  first, interior nodes as their subtrees complete.
* A node is done exactly when its body has a ledger marker, the durable
  commit the worker's ``delete-task-in-queue`` writes, so the children's
  commits are what unlock the parent.
* :meth:`sync` folds the ledger into the tree and enqueues every newly
  runnable node; :meth:`run` loops it until the tree is done.

A killed worker is the queue's business (redelivery, then a ledger skip
or an idempotent replay). A killed coordinator rebuilds the tree from
the plan and folds the ledger; duplicates of messages still queued end
in ledger skips. ``next_ready_task`` claims in pre-order, so the order
is deterministic: leaves along the split axes, every interior node
after both children.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from chunkflow_tpu_torch.parallel.lifecycle import LedgerBase
from chunkflow_tpu_torch.parallel.task_tree import SpatialTaskTree


class TreeTaskSource:
    """Pump a dependency tree into a task queue. ``body`` maps a node to
    its queue body and ledger key (default: its bbox string). One
    instance drives one tree from one thread; the queue and ledger make
    it safe across processes."""

    def __init__(self, tree: SpatialTaskTree, queue, ledger: LedgerBase,
                 body: Optional[Callable[[SpatialTaskTree], str]] = None):
        if ledger is None:
            raise ValueError("TreeTaskSource needs a ledger: children's "
                             "ledger commits are what unlock the parent "
                             "task")
        self.tree = tree
        self.queue = queue
        self.ledger = ledger
        self._body = body or (lambda node: node.bbox.string)
        self.enqueued = 0

    def sync(self) -> int:
        """One round: fold the ledger's commits into the tree, then
        enqueue every newly runnable node. Returns how many went out."""
        for node in self.tree.walk():
            if not node.is_done and self.ledger.is_done(self._body(node)):
                node.set_state_done()
        bodies: List[str] = []
        while True:
            node = self.tree.next_ready_task()
            if node is None:
                break
            bodies.append(self._body(node))
        if bodies:
            self.queue.send_messages(bodies)
            self.enqueued += len(bodies)
        return len(bodies)

    @property
    def all_done(self) -> bool:
        return self.tree.all_done

    def pending(self) -> int:
        return sum(1 for node in self.tree.walk() if not node.is_done)

    def run(self, poll_interval: float = 0.05,
            timeout: Optional[float] = None) -> int:
        """Pump until the tree is done; returns the bodies this source
        enqueued. TimeoutError past ``timeout`` with nodes outstanding
        (the queue keeps the claimed work)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self.sync()
            if self.tree.all_done:
                return self.enqueued
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"task tree incomplete after {timeout}s: "
                                   f"{self.pending()} nodes outstanding")
            time.sleep(poll_interval)
