"""Neuron skeletons: SWC text and precomputed skeleton fragments (the
counterpart of ``chunkflow_tpu/annotations/skeleton.py``).

A skeleton is nodes [N, 3] zyx in nm, radii [N] and a parent array [N]
(-1 for a root): the SWC tree.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np


class Skeleton:
    def __init__(
        self,
        nodes: np.ndarray,            # [N, 3] zyx physical (nm)
        parents: np.ndarray,          # [N] int, -1 = root
        radii: Optional[np.ndarray] = None,
        node_types: Optional[np.ndarray] = None,
    ):
        self.nodes = np.asarray(nodes, dtype=np.float32).reshape(-1, 3)
        self.parents = np.asarray(parents, dtype=np.int64).reshape(-1)
        n = self.nodes.shape[0]
        assert self.parents.shape[0] == n
        self.radii = (
            np.asarray(radii, dtype=np.float32)
            if radii is not None
            else np.ones(n, dtype=np.float32)
        )
        self.node_types = (
            np.asarray(node_types, dtype=np.int32)
            if node_types is not None
            else np.zeros(n, dtype=np.int32)
        )

    def __len__(self) -> int:
        return self.nodes.shape[0]

    @property
    def edges(self) -> np.ndarray:
        child = np.nonzero(self.parents >= 0)[0]
        return np.stack([child, self.parents[child]], axis=1)

    def cable_length(self) -> float:
        e = self.edges
        if e.size == 0:
            return 0.0
        diffs = self.nodes[e[:, 0]] - self.nodes[e[:, 1]]
        return float(np.linalg.norm(diffs, axis=1).sum())

    # ---- SWC -----------------------------------------------------------
    def to_swc(self, path: str) -> str:
        """SWC: ``id type x y z radius parent`` (xyz order, 1-based ids),
        under the JAX package's header line."""
        with open(path, "w") as f:
            f.write("# generated by chunkflow-tpu\n")
            for i in range(len(self)):
                z, y, x = self.nodes[i]
                parent = self.parents[i]
                f.write(
                    f"{i + 1} {self.node_types[i]} {x} {y} {z} "
                    f"{self.radii[i]} {parent + 1 if parent >= 0 else -1}\n"
                )
        return path

    @classmethod
    def from_swc(cls, path: str) -> "Skeleton":
        nodes, radii, parents, types = [], [], [], []
        id_map = {}
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                rows.append(parts)
                id_map[int(parts[0])] = len(rows) - 1
        for parts in rows:
            types.append(int(parts[1]))
            x, y, z = float(parts[2]), float(parts[3]), float(parts[4])
            nodes.append((z, y, x))
            radii.append(float(parts[5]))
            raw_parent = int(parts[6])
            parents.append(id_map[raw_parent] if raw_parent != -1 else -1)
        return cls(
            np.asarray(nodes), np.asarray(parents),
            radii=np.asarray(radii), node_types=np.asarray(types),
        )

    # ---- neuroglancer precomputed skeleton fragment --------------------
    def to_precomputed_bytes(self) -> bytes:
        """uint32 n_vertices, uint32 n_edges, float32 xyz * n, uint32 edge
        pairs, then the ``radius`` vertex attribute (float32 * n)."""
        e = self.edges
        blob = struct.pack("<II", len(self), e.shape[0])
        xyz = self.nodes[:, ::-1]  # zyx -> xyz
        blob += xyz.astype("<f4").tobytes()
        blob += e.astype("<u4").tobytes()
        blob += self.radii.astype("<f4").tobytes()
        return blob

    @classmethod
    def from_precomputed_bytes(cls, blob: bytes) -> "Skeleton":
        nv, ne = struct.unpack("<II", blob[:8])
        offset = 8
        xyz = np.frombuffer(blob, dtype="<f4", count=nv * 3, offset=offset)
        xyz = xyz.reshape(nv, 3)
        offset += nv * 12
        edges = np.frombuffer(blob, dtype="<u4", count=ne * 2, offset=offset)
        edges = edges.reshape(ne, 2).astype(np.int64)
        offset += ne * 8
        # the radius attribute is optional (absent in minimal blobs)
        radii = None
        if len(blob) >= offset + nv * 4:
            radii = np.frombuffer(blob, dtype="<f4", count=nv, offset=offset)
        # The edge pairs carry no orientation: the parents are rebuilt by
        # a walk over the adjacency lists that roots each component at
        # its smallest node id. The walk pops the LAST entry (a stack), as
        # the JAX package's does, so the parent arrays are the same.
        adjacency: list[list[int]] = [[] for _ in range(nv)]
        for a, b in edges:
            adjacency[a].append(int(b))
            adjacency[b].append(int(a))
        parents = np.full(nv, -1, dtype=np.int64)
        seen = np.zeros(nv, dtype=bool)
        for start in range(nv):
            if seen[start]:
                continue
            seen[start] = True
            stack = [start]
            while stack:
                node = stack.pop()
                for neighbor in adjacency[node]:
                    if not seen[neighbor]:
                        seen[neighbor] = True
                        parents[neighbor] = node
                        stack.append(neighbor)
        return cls(xyz[:, ::-1].copy(), parents, radii=radii)
