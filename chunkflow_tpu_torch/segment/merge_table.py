"""Union-find over edge sets, and label-isomorphism.

The port's copy of ``union_find`` and ``labels_isomorphic`` from
``chunkflow_tpu/segment/merge_table.py``: the multi-value connected
components split mixed components with the first, and tests compare
labelings with the second. The rest of that module (the merge tables of
the segmentation plane) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

EDGE_DTYPE = np.uint64


def union_find(edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized union-find over an ``(N, 2)`` edge set.

    Returns ``(ids, roots)``: the sorted unique ids appearing in any
    edge and, positionally, each id's canonical representative — the
    MINIMUM id of its connected component. Ids are compressed to dense
    indices (searchsorted); then full pointer-jumping path compression
    alternates with min-relinking of every edge's two roots until no
    edge spans two components."""
    edges = np.asarray(edges, dtype=EDGE_DTYPE).reshape(-1, 2)
    ids = np.unique(edges)
    if ids.size == 0:
        return ids, ids.copy()
    idx = np.searchsorted(ids, edges)
    parent = np.arange(ids.size, dtype=np.int64)
    while True:
        while True:  # full path compression by pointer jumping
            jumped = parent[parent]
            if np.array_equal(jumped, parent):
                break
            parent = jumped
        root_a = parent[idx[:, 0]]
        root_b = parent[idx[:, 1]]
        merged = root_a != root_b
        if not merged.any():
            break
        lo = np.minimum(root_a[merged], root_b[merged])
        hi = np.maximum(root_a[merged], root_b[merged])
        # several edges may target one root: np.minimum.at keeps the
        # smallest, the next compression round absorbs chains
        np.minimum.at(parent, hi, lo)
    return ids, ids[parent]


def labels_isomorphic(a: np.ndarray, b: np.ndarray) -> bool:
    """Exact bijective agreement of two labelings: the same background
    support, and the nonzero (a, b) value pairs form a one-to-one
    mapping in both directions."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    a = a.ravel()
    b = b.ravel()
    zero_a = a == 0
    if not np.array_equal(zero_a, b == 0):
        return False
    nz = ~zero_a
    pairs = np.stack([a[nz].astype(np.uint64), b[nz].astype(np.uint64)],
                     axis=1)
    pairs = np.unique(pairs, axis=0)
    return bool(np.unique(pairs[:, 0]).size == pairs.shape[0]
                and np.unique(pairs[:, 1]).size == pairs.shape[0])
