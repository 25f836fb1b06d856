"""Meshing: a segmentation chunk to per-object mesh files.

The port's copy of ``chunkflow_tpu/flow/mesh.py``, host work as there:
the native surface-nets mesher (``native.mesh_object``,
``csrc/host/surface_nets.cpp``), vertices scaled to nanometres and moved
into global coordinates, then written as

- ``precomputed``: the legacy single-resolution fragment (uint32 vertex
  count, float32 xyz in nm, uint32 triangle indices) named
  ``<obj_id>:0:<bbox>``, beside a ``<obj_id>:0`` manifest;
- ``obj`` / ``ply``: one text file per object and chunk.

Every file is byte for byte the JAX package's. A chunk lying on the card
is read back once.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from chunkflow_tpu_torch.chunk.base import Chunk, as_native_dtype


def mesh_chunk(seg: Chunk, ids=None,
               skip_ids=()) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Mesh every (selected) object: id -> (vertices in nm, xyz; faces).
    Surface nets scan the chunk once per object."""
    from chunkflow_tpu_torch import native

    arr = as_native_dtype(seg.array)
    if arr.ndim == 4:
        arr = arr[0]
    if ids is None:
        ids = [int(i) for i in np.unique(arr) if i != 0]
    voxel_size_xyz = np.asarray(tuple(reversed(seg.voxel_size)),
                                dtype=np.float32)
    offset_xyz = np.asarray(tuple(reversed(seg.voxel_offset)),
                            dtype=np.float32)
    meshes = {}
    for obj_id in ids:
        if obj_id in skip_ids:
            continue
        vertices, faces = native.mesh_object(arr, obj_id)
        if vertices.shape[0] == 0:
            continue
        vertices = (vertices + offset_xyz) * voxel_size_xyz  # global nm
        meshes[int(obj_id)] = (vertices, faces)
    return meshes


def simplify_mesh(vertices: np.ndarray, faces: np.ndarray,
                  cell_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex clustering: merge the vertices of each ``cell_size`` grid
    cell at their mean (the error stays within a cell), and drop the
    faces that degenerate."""
    if vertices.shape[0] == 0 or cell_size <= 0:
        return vertices, faces
    cells = np.floor(vertices / float(cell_size)).astype(np.int64)
    _, inverse = np.unique(cells, axis=0, return_inverse=True)
    counts = np.bincount(inverse)
    new_vertices = np.zeros((counts.size, 3), dtype=vertices.dtype)
    for axis in range(3):
        new_vertices[:, axis] = (
            np.bincount(inverse, weights=vertices[:, axis]) / counts)
    new_faces = inverse[faces]
    keep = ((new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 2] != new_faces[:, 0]))
    return new_vertices, new_faces[keep].astype(faces.dtype)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------
def to_precomputed_bytes(vertices: np.ndarray, faces: np.ndarray) -> bytes:
    header = struct.pack("<I", vertices.shape[0])
    return (header + vertices.astype("<f4").tobytes()
            + faces.astype("<u4").tobytes())


def from_precomputed_bytes(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of :func:`to_precomputed_bytes`."""
    (nv,) = struct.unpack("<I", blob[:4])
    vertices = np.frombuffer(blob, dtype="<f4", count=nv * 3, offset=4)
    vertices = vertices.reshape(nv, 3)
    faces = np.frombuffer(blob, dtype="<u4", offset=4 + nv * 12)
    return vertices.copy(), faces.reshape(-1, 3).copy()


def download_mesh(mesh_dir: str,
                  obj_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One object's fragments, listed in its ``{id}:0`` manifest, fused
    into one mesh; None without a manifest or fragments."""
    manifest_path = os.path.join(mesh_dir, f"{obj_id}:0")
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    all_vertices, all_faces = [], []
    base = 0
    for frag in manifest["fragments"]:
        with open(os.path.join(mesh_dir, frag), "rb") as f:
            vertices, faces = from_precomputed_bytes(f.read())
        all_vertices.append(vertices)
        all_faces.append(faces + base)
        base += vertices.shape[0]
    if not all_vertices:
        return None
    return np.concatenate(all_vertices), np.concatenate(all_faces)


def to_obj(vertices: np.ndarray, faces: np.ndarray) -> str:
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in vertices]
    lines += [f"f {f[0]+1} {f[1]+1} {f[2]+1}" for f in faces]
    return "\n".join(lines) + "\n"


def to_ply(vertices: np.ndarray, faces: np.ndarray) -> str:
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {vertices.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {faces.shape[0]}\n"
              "property list uchar int vertex_index\nend_header\n")
    body = "\n".join(f"{v[0]} {v[1]} {v[2]}" for v in vertices)
    body += "\n" + "\n".join(f"3 {f[0]} {f[1]} {f[2]}" for f in faces)
    return header + body + "\n"


class MeshOperator:
    """Mesh a segmentation chunk into ``output_path`` (the ``mesh``
    command)."""

    # one lock for every instance in the process: relabel tasks meshing
    # one cross-chunk object in several threads must not interleave the
    # list-then-write of its manifest
    _manifest_lock = threading.Lock()

    def __init__(self, output_path: str, output_format: str = "precomputed",
                 ids=None, skip_ids=(), manifest: bool = False,
                 simplification_error_nm: float = 0.0):
        if output_format not in ("precomputed", "obj", "ply"):
            raise ValueError(f"unknown mesh format {output_format!r}")
        self.output_path = output_path
        self.output_format = output_format
        self.ids = ids
        self.skip_ids = tuple(skip_ids)
        self.manifest = manifest
        self.simplification_error_nm = simplification_error_nm
        os.makedirs(output_path, exist_ok=True)

    def __call__(self, seg: Chunk) -> int:
        meshes = mesh_chunk(seg, ids=self.ids, skip_ids=self.skip_ids)
        bbox_str = seg.bbox.string
        for obj_id, (vertices, faces) in meshes.items():
            if self.simplification_error_nm > 0:
                vertices, faces = simplify_mesh(
                    vertices, faces, self.simplification_error_nm)
            if self.output_format == "precomputed":
                frag = f"{obj_id}:0:{bbox_str}"
                fpath = os.path.join(self.output_path, frag)
                tmp = f"{fpath}.tmp-{os.getpid()}-{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    f.write(to_precomputed_bytes(vertices, faces))
                os.replace(tmp, fpath)
                if self.manifest:
                    self._write_manifest(obj_id)
            else:
                text = (to_obj if self.output_format == "obj" else to_ply)(
                    vertices, faces)
                path = os.path.join(
                    self.output_path,
                    f"{obj_id}_{bbox_str}.{self.output_format}")
                with open(path, "w") as f:
                    f.write(text)
        return len(meshes)

    def _write_manifest(self, obj_id) -> None:
        """Rewrite ``{obj_id}:0`` from the fragments on disk: derived
        state, so a re-meshed chunk rewrites the same bytes, and an
        atomic replace, so a reader never sees torn JSON. Across
        processes a manifest may miss a fragment another worker is
        adding; :func:`write_manifests` after the job is the
        authoritative sweep."""
        prefix = f"{obj_id}:0:"
        with self._manifest_lock:
            frags = sorted(name for name in os.listdir(self.output_path)
                           if name.startswith(prefix)
                           and ".tmp-" not in name)
            mpath = os.path.join(self.output_path, f"{obj_id}:0")
            tmp = f"{mpath}.tmp-{os.getpid()}-{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump({"fragments": frags}, f)
            os.replace(tmp, mpath)


def write_manifests(mesh_dir: str, id_prefix: str = None) -> int:
    """One ``{obj_id}:0`` manifest per object over its ``<id>:0:<bbox>``
    fragments (ids starting with ``id_prefix`` only, when given: one job
    per prefix). Returns the number of manifests."""
    fragments: Dict[str, list] = {}
    for name in os.listdir(mesh_dir):
        parts = name.split(":")
        if len(parts) == 3 and parts[1] == "0" and ".tmp-" not in name:
            if id_prefix and not parts[0].startswith(id_prefix):
                continue
            fragments.setdefault(parts[0], []).append(name)
    for obj_id, frags in fragments.items():
        with open(os.path.join(mesh_dir, f"{obj_id}:0"), "w") as f:
            json.dump({"fragments": sorted(frags)}, f)
    return len(fragments)
